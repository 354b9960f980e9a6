// The FFT route's stages, shared by the two fused frontend kernels
// (mfcc_fused.cu, log_mel_fused.cu): a block's sample span -> per frame a
// windowed real FFT -> power -> a sparse mel product, leaving one row of
// mel values per frame in shared memory. Each kernel adds its own epilogue
// (the DCT-II, or the log rows' copy and the per-clip maximum). Taken for
// n_fft a power of two from 64 to 2048; mel_tile.cuh's dense DFT serves
// every other n_fft.
//
// What bounds it: per frame the function needs a real FFT (~2.5*n*log2(n)
// FLOP, 11.5 k at n = 512), the power and ~490 mel FMAs, ~14 kFLOP against
// the hop's new samples read and the outputs written (~800 bytes at hop 160),
// so on an H100 it is bound by device-memory traffic. What holds this
// design back from that bound, in the order of its cost on an H100 at the
// BirdCLEF shape (kernel_variants.py times variants with a phase cut out):
// phase A, the FFT, ~58% of the time, bound by instruction throughput
// (by a count of this source, ~600 instructions a frame per lane, half of
// them in the five cross-lane stages, beside ~150 shared-memory and
// shuffle wavefronts);
// the span loads, the block's barriers and the epilogue, ~34%, since a
// block computes only after its span has landed; phase B, the mel product,
// ~10%. The design, phase by phase:
//   * span load: a block takes up to FRAMES (32) consecutive frames of ONE
//     clip and copies their sample span once with cp.async, coalesced
//     (16-byte copies where the span is interior and aligned), reflecting
//     at the clip edges (numpy "reflect", edge sample not repeated), with
//     the constant tables beside it. Overlapping frames read the span from
//     shared memory, not again from L2 or device memory. Blocks are sized
//     so that three fit on an SM;
//   * A, one warp per frame: the n-point real frame, windowed as it is read
//     (8-byte pairs when the hop is even), is packed as an N = n/2-point
//     complex FFT, z[m] = x[2m] + i*x[2m+1], with N = P x 32: a P-point FFT
//     in each lane's registers, a twiddle, then a 32-point FFT across the
//     lanes with __shfl_xor_sync. Full f32 FMA, no TF32, no tensor cores
//     (the librosa match needs f32, and the FFT's arithmetic is below the
//     bytes bound). The twiddles come from a table the host computed in
//     float64, laid out so that every read is a broadcast or conflict-free.
//     The split of Z into the N + 1 real bins goes through the warp's
//     scratch (padded every 32 entries, so the bit-reversed lane order
//     writes without bank conflicts), and the power lands in the frame's
//     row of the block's power rows (row stride N + 1, 1 mod 32);
//   * B, one lane per frame: each warp takes whole mel bands (the host
//     lists them longest first; the rounds snake over the warps) and each
//     lane sums its frame's power over the band's contiguous bin range
//     with the band's weights (the host's CSR form of the filter bank):
//     ~490 FMAs a frame at 40 mels,
//     every lane of a warp on the same band (no divergence), power reads
//     conflict-free, weights broadcast, and in a fixed order, so two
//     launches give identical bits.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace mel_fft {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int FRAMES = 32;  // frames per block at most: one lane each in B
constexpr size_t SMEM_TARGET = 75 * 1024;  // bytes a block: three an SM
constexpr size_t SMEM_MAX = 227 * 1024;     // bytes a block can have
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int bitrev(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((v >> i) & 1);
  return r;
}

// Index of Z[k] in a warp's scratch: one float of padding after every 32.
__host__ __device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline int max_int(int a, int b) { return a > b ? a : b; }

// Floats of the host-built table, with N = n_fft / 2: window (n_fft) |
// W_N^j, j < N | W_n^k, k <= N/2 | W_N^(lane * bitrev(r)) at [r][lane],
// r < N/32; the last three as (re, im) pairs.
__host__ __device__ inline int table_floats(int n_fft) {
  return n_fft + n_fft + 2 * (n_fft / 4 + 1) + n_fft;
}

// f(std::integral_constant<int, LOG2P>()) for n_fft = 64 << LOG2P, the
// sizes the kernels are built for; any other n_fft is cudaErrorInvalidValue.
template <class F>
inline cudaError_t with_log2p(int n_fft, F&& f) {
  switch (n_fft) {
    case 64: return f(std::integral_constant<int, 0>());
    case 128: return f(std::integral_constant<int, 1>());
    case 256: return f(std::integral_constant<int, 2>());
    case 512: return f(std::integral_constant<int, 3>());
    case 1024: return f(std::integral_constant<int, 4>());
    case 2048: return f(std::integral_constant<int, 5>());
    default: return cudaErrorInvalidValue;
  }
}

// Offsets (in floats) of the dynamic shared-memory regions of one block;
// the same arithmetic on the host (size) and in the kernel (pointers).
// Rows of mel values (stride mel_stride) reuse the span once phase A is
// done, and rows of DCT outputs (stride out_stride) the warps' scratch;
// both strides are odd, so lane-per-row accesses are conflict-free.
struct Layout {
  int tables, csr, weights, dct, scratch, bmax, power, span;
  int mel_stride, out_stride, total;
  __host__ __device__ Layout(int n_fft, int n_mels, int nnz, int n_mfcc,
                             int frames, int span_len) {
    const int n = n_fft / 2;
    mel_stride = n_mels | 1;
    out_stride = n_mfcc | 1;
    tables = 0;
    csr = round4(table_floats(n_fft));    // start | count | offset | order
    weights = csr + round4(4 * n_mels);
    dct = weights + round4(nnz);           // n_mels x n_mfcc
    scratch = dct + round4(n_mels * n_mfcc);
    bmax = scratch + round4(max_int(WARPS * 2 * (padded(n) + 1),
                                    frames * out_stride));
    power = bmax + round4(WARPS);          // frames x (N + 1)
    span = power + round4(frames * (n + 1));
    total = span + round4(max_int(span_len, frames * mel_stride));
  }
};

// Frames per block and blocks per clip: the most frames, up to FRAMES,
// whose block fits SMEM_TARGET bytes, else the whole shared memory of an
// SM; then spread evenly over the clip's blocks.
inline void block_geometry(int n_frames, int n_fft, int hop, int n_mels,
                           int nnz, int n_mfcc, int* frames, int* blocks) {
  int r = FRAMES < n_frames ? FRAMES : n_frames;
  const auto bytes = [&](int f) {
    return sizeof(float) *
           (size_t)Layout(n_fft, n_mels, nnz, n_mfcc, f, (f - 1) * hop + n_fft)
               .total;
  };
  const size_t limit = bytes(1) <= SMEM_TARGET ? SMEM_TARGET : SMEM_MAX;
  while (r > 1 && bytes(r) > limit) --r;
  *blocks = (n_frames + r - 1) / r;
  *frames = (n_frames + *blocks - 1) / *blocks;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Asynchronous copies from global to shared memory (cp.async), so that all
// of a block's loads are in flight at once.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Stage the block's constant tables and its sample span into shared
// memory. y points at the clip's first sample; g0 is the (possibly
// negative) clip index of span[0].
__device__ __forceinline__ void load_block(
    float* smem, const Layout& lay, const float* __restrict__ tables,
    int n_tables, const int* __restrict__ csr, const float* __restrict__ mel_w,
    int n_mels, int nnz, const float* __restrict__ dct, int n_dct,
    const float* __restrict__ y, int n_samples, long long g0, int span_len) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n_tables; i += THREADS)
    copy4(smem + lay.tables + i, tables + i);
  for (int i = tid; i < 4 * n_mels; i += THREADS) copy4(smem + lay.csr + i, csr + i);
  for (int i = tid; i < nnz; i += THREADS) copy4(smem + lay.weights + i, mel_w + i);
  for (int i = tid; i < n_dct; i += THREADS) copy4(smem + lay.dct + i, dct + i);
  float* span = smem + lay.span;
  const bool interior = g0 >= 0 && g0 + span_len <= n_samples;
  if (interior && (reinterpret_cast<size_t>(y + g0) & 15) == 0) {
    const int n4 = span_len / 4;
    for (int i = tid; i < n4; i += THREADS) copy16(span + 4 * i, y + g0 + 4 * i);
    for (int i = 4 * n4 + tid; i < span_len; i += THREADS)
      copy4(span + i, y + g0 + i);
  } else {
    for (int i = tid; i < span_len; i += THREADS) {
      long long j = g0 + i;
      if (j < 0) j = -j;                          // numpy "reflect"
      if (j >= n_samples) j = 2 * (long long)(n_samples - 1) - j;
      copy4(span + i, y + j);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// One frame's power spectrum, by one warp. x: the frame's first sample in
// the span; pairs: x is 8-byte aligned (even hop). Writes power[k], k =
// 0..N, to dst and returns after a __syncwarp.
template <int LOG2P>
__device__ __forceinline__ void frame_power(
    const float* x, bool pairs, const float* win, const float2* tw,
    const float2* tws, const float2* twl, const float2 (&wx)[5], float* re,
    float* im, float* dst, int lane) {
  constexpr int P = 1 << LOG2P;
  constexpr int N = 32 * P;
  float vr[P], vi[P];
  // z[m] = x[2m] + i*x[2m+1] for m = 32p + lane, windowed as read
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = 64 * p + 2 * lane;
    const float2 w = *reinterpret_cast<const float2*>(win + j);
    const float2 v = pairs ? *reinterpret_cast<const float2*>(x + j)
                           : make_float2(x[j], x[j + 1]);
    vr[p] = v.x * w.x;
    vi[p] = v.y * w.y;
  }
  // P-point decimation-in-frequency FFT over the registers: register r
  // ends holding A[bitrev(r)] of this lane's column m2 = lane
#pragma unroll
  for (int st = 1; st <= LOG2P; ++st) {
    const int h = P >> st;  // butterfly span of this stage
#pragma unroll
    for (int gi = 0; gi < (1 << (st - 1)); ++gi) {
      const int g = gi * 2 * h;
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const float ar = vr[g + j], ai = vi[g + j];
        const float br = vr[g + j + h], bi = vi[g + j + h];
        vr[g + j] = ar + br;
        vi[g + j] = ai + bi;
        const float dr = ar - br, di = ai - bi;
        if (j == 0) {
          vr[g + j + h] = dr;
          vi[g + j + h] = di;
        } else {
          const float2 w = tw[j * (N / (2 * h))];  // a broadcast
          vr[g + j + h] = dr * w.x - di * w.y;
          vi[g + j + h] = dr * w.y + di * w.x;
        }
      }
    }
  }
  // twiddle between the two factors: A[k1] *= W_N^(lane * k1), from the
  // [r][lane] table (conflict-free)
#pragma unroll
  for (int r = 1; r < P; ++r) {
    const float2 w = twl[32 * r + lane];
    const float ar = vr[r], ai = vi[r];
    vr[r] = ar * w.x - ai * w.y;
    vi[r] = ar * w.y + ai * w.x;
  }
  // 32-point decimation-in-frequency FFT across the lanes: after it lane l
  // holds Z[k1 + P * bitrev5(l)] in register r (k1 = bitrev(r))
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int d = 16 >> s;
    const float sgn = (lane & d) ? -1.f : 1.f;  // upper: q - v, lower: v + q
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const float qr = __shfl_xor_sync(FULL, vr[r], d);
      const float qi = __shfl_xor_sync(FULL, vi[r], d);
      const float tr = fmaf(sgn, vr[r], qr), ti = fmaf(sgn, vi[r], qi);
      vr[r] = tr * wx[s].x - ti * wx[s].y;
      vi[r] = tr * wx[s].y + ti * wx[s].x;
    }
  }
  const int k2 = bitrev(lane, 5);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int k = bitrev(r, LOG2P) + P * k2;
    re[padded(k)] = vr[r];
    im[padded(k)] = vi[r];
  }
  __syncwarp();
  // split into the real spectrum: X[k] = E + W_n^k O, X[N-k] = conj(E - W_n^k O)
  // with E = (Z[k] + conj Z[N-k]) / 2, O = -i (Z[k] - conj Z[N-k]) / 2, for
  // 0 < k < N/2; bins 0 and N come from Z[0], bin N/2 is |Z[N/2]|^2
  for (int k = lane; k < N / 2; k += 32) {
    if (k == 0) {
      const float zr = re[0], zi = im[0];
      const float hr = re[padded(N / 2)], hi = im[padded(N / 2)];
      dst[0] = (zr + zi) * (zr + zi);
      dst[N] = (zr - zi) * (zr - zi);
      dst[N / 2] = hr * hr + hi * hi;
      continue;
    }
    const int kk = N - k;
    const float ar = re[padded(k)], ai = im[padded(k)];
    const float br = re[padded(kk)], bi = -im[padded(kk)];
    const float er = 0.5f * (ar + br), ei = 0.5f * (ai + bi);
    const float o_r = 0.5f * (ai - bi), o_i = -0.5f * (ar - br);
    const float2 w = tws[k];
    const float wr = w.x * o_r - w.y * o_i, wi = w.x * o_i + w.y * o_r;
    const float pr = er + wr, pi = ei + wi, qr = er - wr, qi = ei - wi;
    dst[k] = pr * pr + pi * pi;
    dst[kk] = qr * qr + qi * qi;
  }
  __syncwarp();  // the next frame overwrites the scratch
}

// Phases A and B of one block: stages its tables and span (load_block),
// computes the power rows of its rb frames, then the mel rows
// rows[f * lay.mel_stride + m] = epi(mel band m of frame f). Returns after a
// __syncthreads.
template <int LOG2P, class Epi>
__device__ __forceinline__ void mel_rows(
    float* smem, const Layout& lay, const float* __restrict__ tables,
    const int* __restrict__ csr, const float* __restrict__ mel_w, int n_mels,
    int nnz, const float* __restrict__ dct, int n_dct,
    const float* __restrict__ y, int n_samples, long long g0, int span_len,
    int hop, int rb, Epi&& epi) {
  constexpr int N = 32 << LOG2P;
  constexpr int n_fft = 2 * N;
  load_block(smem, lay, tables, table_floats(n_fft), csr, mel_w, n_mels, nnz,
             dct, n_dct, y, n_samples, g0, span_len);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* win = smem + lay.tables;
  const float2* tw = reinterpret_cast<const float2*>(win + n_fft);
  const float2* tws = tw + N;
  const float2* twl = tws + (N / 2 + 1);
  float* re = smem + lay.scratch + warp * 2 * (padded(N) + 1);
  float* im = re + padded(N) + 1;
  float* power = smem + lay.power;
  // per-lane twiddles of the cross-lane stages: stage s (lane distance
  // d = 16 >> s) multiplies the upper lane of each pair by W_2d^(lane mod d)
  // = W_N^((lane mod d) * (16 / d) * P), the lower lane by 1
  float2 wx[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int d = 16 >> s;
    wx[s] = (lane & d) ? tw[(lane % d) * (16 / d) * (N / 32)]
                       : make_float2(1.f, 0.f);
  }
  const bool pairs = hop % 2 == 0;
  for (int f = warp; f < rb; f += WARPS)
    frame_power<LOG2P>(smem + lay.span + f * hop, pairs, win, tw, tws, twl,
                       wx, re, im, power + f * (N + 1), lane);
  __syncthreads();  // the power rows are complete; the span is free

  const int* start = reinterpret_cast<const int*>(smem + lay.csr);
  const int* count = start + n_mels;
  const int* offset = count + n_mels;
  const int* order = offset + n_mels;  // the bands, longest first
  const float* weights = smem + lay.weights;
  float* rows = smem + lay.span;
  if (lane < rb) {
    const float* p = power + lane * (N + 1);
    // round base / WARPS gives each warp one band of order[base, base +
    // len); odd rounds run backwards, so the warps' loads even out
    for (int base = 0; base < n_mels; base += WARPS) {
      const int len = min(WARPS, n_mels - base);
      if (warp >= len) break;
      const int m = order[base + ((base / WARPS) % 2 ? len - 1 - warp : warp)];
      const float* pm = p + start[m];
      const float* wm = weights + offset[m];
      float acc = 0.f;
      for (int i = 0; i < count[m]; ++i) acc = fmaf(pm[i], wm[i], acc);
      rows[lane * lay.mel_stride + m] = epi(acc);
    }
  }
  __syncthreads();
}

}  // namespace mel_fft
