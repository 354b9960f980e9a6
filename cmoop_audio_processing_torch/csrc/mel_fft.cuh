// The FFT route's stages, shared by the two fused frontend kernels
// (mfcc_fused.cu, log_mel_fused.cu): a block's sample span -> per frame a
// windowed real FFT -> power -> a sparse mel product, leaving one row of
// mel values per frame in shared memory. Each kernel adds its own epilogue
// (the DCT-II, or the log rows' copy and the per-clip maximum). Taken for
// the n_fft that with_plan lists: every even n_fft from 64 to 2048 whose
// half N = n_fft/2 factors as 2^a 3^b 5^c with at most 32 points a lane
// (P <= 32 below); mel_tile.cuh's dense DFT serves every other n_fft.
//
// What bounds it: per frame the function needs a real FFT (~2.5*n*log2(n)
// FLOP, 11.5 k at n = 512), the power and ~490 mel FMAs, ~14 kFLOP against
// the hop's new samples read and the outputs written (~800 bytes at hop 160),
// so on an H100 it is bound by device-memory traffic. What holds this
// design back from that bound, in the order of its cost on an H100 at the
// BirdCLEF shape and n_fft 512 (kernel_variants.py times variants with a
// phase cut out):
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
//   * A: the n-point real frame, windowed as it is read (8-byte pairs when
//     the hop is even), is packed as an N = n/2-point complex FFT, z[m] =
//     x[2m] + i*x[2m+1], with N = P x Q: a P-point FFT in each lane's
//     registers, a twiddle, then a Q-point FFT across Q lanes with
//     __shfl_xor_sync. Full f32 FMA, no TF32, no tensor cores (the librosa
//     match needs f32, and the FFT's arithmetic is below the bytes bound).
//     The twiddles come from a table the host computed in float64, laid out
//     so that every read is a broadcast or conflict-free. Two plans:
//       - radix 2 (n_fft a power of two): Q = 32, one warp per frame, P =
//         N/32 by radix-2 stages. The split of Z into the N + 1 real bins
//         goes through the warp's scratch (padded every 32 entries, so the
//         bit-reversed lane order writes without bank conflicts);
//       - mixed radix (N = 2^a 3^b 5^c, not a power of two): Q = the largest
//         power of two dividing N, at most 32, so a warp takes 32/Q frames
//         at once, Q lanes each (400: N = 200 = 25 x 8, four frames a
//         warp); the P-point FFT runs by a compile-time plan of radix-5,
//         3, 4 and 2 stages (constant-coefficient butterflies, constant
//         twiddles between them), Q is read at run time. The split needs no
//         scratch: Z[N-k] for a lane's Z[k] sits in the lane l ^ (Q-1) of
//         its group, in a register the plan knows (one __shfl_sync from
//         another lane of the group for k1 = 0), so each lane forms its own
//         P bins;
//     the power lands in the frame's row of the block's power rows (row
//     stride N + 1);
//   * B, one lane per frame: each warp takes whole mel bands (the host
//     lists them longest first; the rounds snake over the warps) and each
//     lane sums its frame's power over the band's contiguous bin range
//     with the band's weights (the host's CSR form of the filter bank):
//     ~490 FMAs a frame at 40 mels,
//     every lane of a warp on the same band (no divergence), power reads
//     conflict-free (the row stride is odd), weights broadcast, and in a
//     fixed order, so two launches give identical bits.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

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

__host__ __device__ constexpr bool pow2(int v) { return (v & (v - 1)) == 0; }

__host__ __device__ constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

// The mixed-radix plan of an L-point FFT in registers: its first stage's
// radix (5, then 3, then 4, then 2), and the frequency that register pos
// holds once the decimation-in-frequency stages are done (dif_order) or
// the register that holds frequency k (dif_position).
__host__ __device__ constexpr int first_radix(int L) {
  return L % 5 == 0 ? 5 : L % 3 == 0 ? 3 : L % 4 == 0 ? 4 : 2;
}

__host__ __device__ constexpr int dif_order(int L, int pos) {
  return L == 1 ? 0
                : first_radix(L) * dif_order(L / first_radix(L),
                                             pos % (L / first_radix(L))) +
                      pos / (L / first_radix(L));
}

__host__ __device__ constexpr int dif_position(int L, int k) {
  int pos = 0;
  while (dif_order(L, pos) != k) ++pos;
  return pos;
}

// Floats of the host-built table, with N = n_fft / 2 = P x Q, all but the
// window as (re, im) pairs: radix 2, window (n_fft) | W_N^j, j < N | W_n^k,
// k <= N/2 | W_N^(lane * bitrev(r)) at [r][lane], r < N/32; mixed radix,
// window (n_fft) | W_N^j, j < N | W_N^(l * dif_order(P, r)) at [r][l] |
// W_n^(dif_order(P, r) + P * bitrev_Q(l)) at [r][l], r < P, l < Q.
__host__ __device__ inline int table_floats(int n_fft) {
  return pow2(n_fft) ? n_fft + n_fft + 2 * (n_fft / 4 + 1) + n_fft
                     : 4 * n_fft;
}

// f(std::integral_constant<int, P>()) with P the points a lane holds (N =
// n_fft/2 = P x Q), for the n_fft the kernels are built for (the radix-2
// plan for the powers of two, the mixed plan for the rest; P <= 32); any
// other n_fft is cudaErrorInvalidValue. frontend/cuda_kernels.py's
// FFT_SIZES lists the same sizes.
template <class F>
inline cudaError_t with_plan(int n_fft, F&& f) {
  switch (n_fft) {
    case 64: return f(std::integral_constant<int, 1>());
    case 72: return f(std::integral_constant<int, 9>());
    case 80: return f(std::integral_constant<int, 5>());
    case 96: return f(std::integral_constant<int, 3>());
    case 100: return f(std::integral_constant<int, 25>());
    case 108: return f(std::integral_constant<int, 27>());
    case 120: return f(std::integral_constant<int, 15>());
    case 128: return f(std::integral_constant<int, 2>());
    case 144: return f(std::integral_constant<int, 9>());
    case 160: return f(std::integral_constant<int, 5>());
    case 192: return f(std::integral_constant<int, 3>());
    case 200: return f(std::integral_constant<int, 25>());
    case 216: return f(std::integral_constant<int, 27>());
    case 240: return f(std::integral_constant<int, 15>());
    case 256: return f(std::integral_constant<int, 4>());
    case 288: return f(std::integral_constant<int, 9>());
    case 320: return f(std::integral_constant<int, 5>());
    case 384: return f(std::integral_constant<int, 6>());
    case 400: return f(std::integral_constant<int, 25>());
    case 432: return f(std::integral_constant<int, 27>());
    case 480: return f(std::integral_constant<int, 15>());
    case 512: return f(std::integral_constant<int, 8>());
    case 576: return f(std::integral_constant<int, 9>());
    case 640: return f(std::integral_constant<int, 10>());
    case 768: return f(std::integral_constant<int, 12>());
    case 800: return f(std::integral_constant<int, 25>());
    case 864: return f(std::integral_constant<int, 27>());
    case 960: return f(std::integral_constant<int, 15>());
    case 1024: return f(std::integral_constant<int, 16>());
    case 1152: return f(std::integral_constant<int, 18>());
    case 1280: return f(std::integral_constant<int, 20>());
    case 1536: return f(std::integral_constant<int, 24>());
    case 1600: return f(std::integral_constant<int, 25>());
    case 1728: return f(std::integral_constant<int, 27>());
    case 1920: return f(std::integral_constant<int, 30>());
    case 2048: return f(std::integral_constant<int, 32>());
    default: return cudaErrorInvalidValue;
  }
}

// Register plans of the mixed plan, as measured with ptxas for sm_90a: up
// to P = 20 the cross-lane stages are unrolled and the kernel is compiled
// for two blocks an SM (__launch_bounds__'s second argument caps it at 128
// registers a thread; it fits with 0 spills); above, unrolled stages
// overlap their shuffles past 128 registers and spill under that cap, so
// the stages run as a loop and the kernel is compiled for one block (it
// then takes <= 128 registers up to P = 27, ~155 at P = 30, with 0
// spills). The radix-2 plan's kernels keep __launch_bounds__(THREADS).
__host__ __device__ constexpr bool rolled_stages(int P) { return P > 20; }

__host__ __device__ constexpr int min_blocks(int P) {
  return rolled_stages(P) ? 1 : 2;
}

// n_fft of a kernel built for P points a lane: fixed for the radix-2 plan,
// the launch's own (n_fft) for the mixed plan.
template <int P>
__host__ __device__ constexpr int plan_n_fft(int n_fft) {
  return pow2(P) ? 64 * P : n_fft;
}

// Offsets (in floats) of the dynamic shared-memory regions of one block;
// the same arithmetic on the host (size) and in the kernel (pointers).
// Rows of mel values (stride mel_stride) reuse the span once phase A is
// done, and rows of DCT outputs (stride out_stride) the warps' scratch
// (which only the radix-2 plan's split needs); both strides are odd, so
// lane-per-row accesses are conflict-free.
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
    bmax = scratch + round4(max_int(pow2(n_fft) ? WARPS * 2 * (padded(n) + 1)
                                                : 0,
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

// f(std::integral_constant<int, I>()) for each I of the sequence, in order:
// register indices that constexpr functions of the plan can take.
template <class F, int... I>
__device__ __forceinline__ void each(std::integer_sequence<int, I...>, F&& f) {
  (f(std::integral_constant<int, I>()), ...);
}

// An R-point DFT (W_R = exp(-2 pi i / R)) in place, natural order, with
// constant coefficients.
template <int R>
__device__ __forceinline__ void small_dft(float (&xr)[R], float (&xi)[R]) {
  if constexpr (R == 2) {
    const float ar = xr[0], ai = xi[0];
    xr[0] = ar + xr[1];
    xi[0] = ai + xi[1];
    xr[1] = ar - xr[1];
    xi[1] = ai - xi[1];
  } else if constexpr (R == 3) {
    constexpr float S = 0.866025403784438646763723170752936183f;  // sin(2pi/3)
    const float tr = xr[1] + xr[2], ti = xi[1] + xi[2];
    const float dr = S * (xr[1] - xr[2]), di = S * (xi[1] - xi[2]);
    const float mr = fmaf(-0.5f, tr, xr[0]), mi = fmaf(-0.5f, ti, xi[0]);
    xr[0] += tr;
    xi[0] += ti;
    xr[1] = mr + di;
    xi[1] = mi - dr;
    xr[2] = mr - di;
    xi[2] = mi + dr;
  } else if constexpr (R == 4) {
    const float t0r = xr[0] + xr[2], t0i = xi[0] + xi[2];
    const float t1r = xr[0] - xr[2], t1i = xi[0] - xi[2];
    const float t2r = xr[1] + xr[3], t2i = xi[1] + xi[3];
    const float t3r = xr[1] - xr[3], t3i = xi[1] - xi[3];
    xr[0] = t0r + t2r;
    xi[0] = t0i + t2i;
    xr[2] = t0r - t2r;
    xi[2] = t0i - t2i;
    xr[1] = t1r + t3i;  // t1 - i t3
    xi[1] = t1i - t3r;
    xr[3] = t1r - t3i;  // t1 + i t3
    xi[3] = t1i + t3r;
  } else {
    static_assert(R == 5, "radix 2, 3, 4 or 5");
    constexpr float C1 = 0.309016994374947424102293417182819059f;   // cos(2pi/5)
    constexpr float C2 = -0.809016994374947424102293417182819059f;  // cos(4pi/5)
    constexpr float S1 = 0.951056516295153572116439333379382143f;   // sin(2pi/5)
    constexpr float S2 = 0.587785252292473129168705954639072769f;   // sin(4pi/5)
    const float t1r = xr[1] + xr[4], t1i = xi[1] + xi[4];
    const float t2r = xr[2] + xr[3], t2i = xi[2] + xi[3];
    const float t3r = xr[1] - xr[4], t3i = xi[1] - xi[4];
    const float t4r = xr[2] - xr[3], t4i = xi[2] - xi[3];
    const float m1r = fmaf(C2, t2r, fmaf(C1, t1r, xr[0]));
    const float m1i = fmaf(C2, t2i, fmaf(C1, t1i, xi[0]));
    const float m2r = fmaf(C1, t2r, fmaf(C2, t1r, xr[0]));
    const float m2i = fmaf(C1, t2i, fmaf(C2, t1i, xi[0]));
    const float n1r = fmaf(S2, t4r, S1 * t3r), n1i = fmaf(S2, t4i, S1 * t3i);
    const float n2r = fmaf(-S1, t4r, S2 * t3r), n2i = fmaf(-S1, t4i, S2 * t3i);
    xr[0] += t1r + t2r;
    xi[0] += t1i + t2i;
    xr[1] = m1r + n1i;  // m1 - i n1
    xi[1] = m1i - n1r;
    xr[4] = m1r - n1i;  // m1 + i n1
    xi[4] = m1i + n1r;
    xr[2] = m2r + n2i;  // m2 - i n2
    xi[2] = m2i - n2r;
    xr[3] = m2r - n2i;  // m2 + i n2
    xi[3] = m2i + n2r;
  }
}

// cos and sin of 2 pi k / n, evaluated at compile time in double (the angle
// reduced by quarter turns to at most pi/4, then Taylor series): the
// in-register FFT's twiddles, as constants in its instructions.
__host__ __device__ constexpr double quarter_sin(double b) {
  double t = b, s = b;
  for (int i = 1; i < 12; ++i) {
    t *= -b * b / ((2 * i) * (2 * i + 1));
    s += t;
  }
  return s;
}

__host__ __device__ constexpr double quarter_cos(double b) {
  double t = 1.0, s = 1.0;
  for (int i = 1; i < 12; ++i) {
    t *= -b * b / ((2 * i - 1) * (2 * i));
    s += t;
  }
  return s;
}

__host__ __device__ constexpr double turn_cos(int k, int n) {
  k %= n;
  const int j = (4 * k + n / 2) / n;  // the nearest quarter turn
  const double b = 1.5707963267948966 * (4 * k - j * n) / n;
  return j % 4 == 0 ? quarter_cos(b)
         : j % 4 == 1 ? -quarter_sin(b)
         : j % 4 == 2 ? -quarter_cos(b)
                      : quarter_sin(b);
}

__host__ __device__ constexpr double turn_sin(int k, int n) {
  k %= n;
  const int j = (4 * k + n / 2) / n;
  const double b = 1.5707963267948966 * (4 * k - j * n) / n;
  return j % 4 == 0 ? quarter_sin(b)
         : j % 4 == 1 ? quarter_cos(b)
         : j % 4 == 2 ? -quarter_sin(b)
                      : -quarter_cos(b);
}

// The L-point decimation-in-frequency FFT of registers [OFF, OFF + L) of a
// P-point plan, L = R x M with R = first_radix(L): for each m < M the
// R-point DFT of registers OFF + m + M*j, j < R, times the constant
// W_L^(m s) for its output s, into register OFF + m + M*s; then the M-point
// FFT of each block [OFF + M*s, OFF + M*(s+1)). Register pos ends holding
// frequency dif_order(L, pos - OFF).
template <int P, int L, int OFF>
__device__ __forceinline__ void dif(float (&vr)[P], float (&vi)[P]);

template <int P, int M, int OFF, int... S>
__device__ __forceinline__ void dif_blocks(float (&vr)[P], float (&vi)[P],
                                           std::integer_sequence<int, S...>) {
  (dif<P, M, OFF + M * S>(vr, vi), ...);
}

template <int P, int L, int OFF>
__device__ __forceinline__ void dif(float (&vr)[P], float (&vi)[P]) {
  if constexpr (L > 1) {
    constexpr int R = first_radix(L), M = L / R;
    each(std::make_integer_sequence<int, M>(), [&](auto mc) {
      constexpr int m = decltype(mc)::value;
      float xr[R], xi[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        xr[j] = vr[OFF + m + M * j];
        xi[j] = vi[OFF + m + M * j];
      }
      small_dft<R>(xr, xi);
      each(std::make_integer_sequence<int, R>(), [&](auto sc) {
        constexpr int s = decltype(sc)::value;
        if constexpr (m * s == 0) {
          vr[OFF + m + M * s] = xr[s];
          vi[OFF + m + M * s] = xi[s];
        } else {
          constexpr float wr = static_cast<float>(turn_cos(m * s, L));
          constexpr float wi = static_cast<float>(-turn_sin(m * s, L));
          vr[OFF + m + M * s] = xr[s] * wr - xi[s] * wi;
          vi[OFF + m + M * s] = xr[s] * wi + xi[s] * wr;
        }
      });
    });
    dif_blocks<P, M, OFF>(vr, vi, std::make_integer_sequence<int, R>());
  }
}

// One frame's power spectrum on the mixed plan, by the Q = q lanes of one
// group (l = lane % q; k2 = bitrev_Q(l); src0 = the warp lane holding
// Z[P * ((Q - k2) mod Q)]). x: the frame's first sample in the span; pairs:
// x is 8-byte aligned (even hop). tw: W_N^j; twl, tws: the [r][l] tables,
// already offset by l. Writes power[k], k = 0..N, to dst when active; every
// lane of the warp must call it (the shuffles span the warp).
template <int P>
__device__ __forceinline__ void frame_power_mixed(
    const float* x, bool pairs, const float* win, const float2* tw,
    const float2* twl, const float2* tws, int q, int l, int k2, int src0,
    float* dst, bool active) {
  float vr[P], vi[P];
  // z[m] = x[2m] + i*x[2m+1] for m = q*p + l, windowed as read
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = 2 * (q * p + l);
    const float2 w = *reinterpret_cast<const float2*>(win + j);
    const float2 v = pairs ? *reinterpret_cast<const float2*>(x + j)
                           : make_float2(x[j], x[j + 1]);
    vr[p] = v.x * w.x;
    vi[p] = v.y * w.y;
  }
  dif<P, P, 0>(vr, vi);
  // A[k1] *= W_N^(l * k1), k1 = dif_order(P, r), from the [r][l] table
#pragma unroll
  for (int r = 1; r < P; ++r) {
    const float2 w = twl[r * q];
    const float ar = vr[r], ai = vi[r];
    vr[r] = ar * w.x - ai * w.y;
    vi[r] = ar * w.y + ai * w.x;
  }
  // Q-point decimation-in-frequency FFT across the group's lanes (stage s
  // at lane distance d = 16 >> s, the stages with d < Q): the upper lane of
  // each pair takes q - v times W_2d^(l mod d) = W_N^((l mod d) * (Q / 2d)
  // * P), the lower v + q (its twiddle read per stage, not held: the
  // registers go to the P points). After it lane l holds Z[k1 + P * k2] in
  // register r
#pragma unroll (rolled_stages(P) ? 1 : 5)
  for (int s = 0; s < 5; ++s) {
    const int d = 16 >> s;
    if (d >= q) continue;  // uniform over the warp
    const bool upper = l & d;
    const float sgn = upper ? -1.f : 1.f;
    const float2 w = upper ? tw[(l % d) * (q / (2 * d)) * P]
                           : make_float2(1.f, 0.f);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const float qr = __shfl_xor_sync(FULL, vr[r], d);
      const float qi = __shfl_xor_sync(FULL, vi[r], d);
      const float tr = fmaf(sgn, vr[r], qr), ti = fmaf(sgn, vi[r], qi);
      vr[r] = tr * w.x - ti * w.y;
      vi[r] = tr * w.y + ti * w.x;
    }
  }
  // the real spectrum: X[k] = E + W_n^k O with E = (Z[k] + conj Z[N-k]) / 2,
  // O = -i (Z[k] - conj Z[N-k]) / 2 (Z[N] = Z[0]), for the lane's own k =
  // k1 + P * k2; Z[N-k] is register dif_position(P, P - k1) of lane
  // l ^ (Q-1), or for k1 = 0 register 0 of lane src0. Bin N = (Re Z[0] -
  // Im Z[0])^2 comes from lane k2 = 0.
  const int n = P * q;
  each(std::make_integer_sequence<int, P>(), [&](auto rc) {
    constexpr int r = decltype(rc)::value;
    constexpr int k1 = dif_order(P, r);
    float br, bi;
    if constexpr (k1 == 0) {
      br = __shfl_sync(FULL, vr[0], src0);
      bi = -__shfl_sync(FULL, vi[0], src0);
    } else {
      constexpr int rp = dif_position(P, P - k1);
      br = __shfl_xor_sync(FULL, vr[rp], q - 1);
      bi = -__shfl_xor_sync(FULL, vi[rp], q - 1);
    }
    const float ar = vr[r], ai = vi[r];
    const float er = 0.5f * (ar + br), ei = 0.5f * (ai + bi);
    const float o_r = 0.5f * (ai - bi), o_i = -0.5f * (ar - br);
    const float2 w = tws[r * q];
    const float pr = er + (w.x * o_r - w.y * o_i);
    const float pi = ei + (w.x * o_i + w.y * o_r);
    if (active) dst[k1 + P * k2] = pr * pr + pi * pi;
  });
  if (active && k2 == 0) {
    const float d = vr[0] - vi[0];
    dst[n] = d * d;
  }
}

// Phases A and B of one block: stages its tables and span (load_block),
// computes the power rows of its rb frames, then the mel rows
// rows[f * lay.mel_stride + m] = epi(mel band m of frame f). P: the plan's
// points a lane (with_plan); n_fft: the launch's (plan_n_fft). Returns
// after a __syncthreads.
template <int P, class Epi>
__device__ __forceinline__ void mel_rows(
    float* smem, const Layout& lay, int n_fft, const float* __restrict__ tables,
    const int* __restrict__ csr, const float* __restrict__ mel_w, int n_mels,
    int nnz, const float* __restrict__ dct, int n_dct,
    const float* __restrict__ y, int n_samples, long long g0, int span_len,
    int hop, int rb, Epi&& epi) {
  n_fft = plan_n_fft<P>(n_fft);
  const int N = n_fft / 2;
  load_block(smem, lay, tables, table_floats(n_fft), csr, mel_w, n_mels, nnz,
             dct, n_dct, y, n_samples, g0, span_len);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* win = smem + lay.tables;
  const float2* tw = reinterpret_cast<const float2*>(win + n_fft);
  float* power = smem + lay.power;
  const bool pairs = hop % 2 == 0;
  if constexpr (pow2(P)) {
    const float2* tws = tw + N;
    const float2* twl = tws + (N / 2 + 1);
    float* re = smem + lay.scratch + warp * 2 * (padded(N) + 1);
    float* im = re + padded(N) + 1;
    // per-lane twiddles of the cross-lane stages: stage s (lane distance
    // d = 16 >> s) multiplies the upper lane of each pair by W_2d^(lane mod
    // d) = W_N^((lane mod d) * (16 / d) * P), the lower lane by 1
    float2 wx[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int d = 16 >> s;
      wx[s] = (lane & d) ? tw[(lane % d) * (16 / d) * (N / 32)]
                         : make_float2(1.f, 0.f);
    }
    for (int f = warp; f < rb; f += WARPS)
      frame_power<log2i(P)>(smem + lay.span + f * hop, pairs, win, tw, tws,
                            twl, wx, re, im, power + f * (N + 1), lane);
  } else {
    // a group of q lanes per frame, 32 / q frames a warp at once
    const int q = N / P, l = lane % q, log2q = 31 - __clz(q);
    const int k2 = __brev(l) >> (32 - log2q);
    const int src0 = (lane & ~(q - 1)) |
                     (__brev((q - k2) & (q - 1)) >> (32 - log2q));
    const float2* twl = tw + N + l;
    const float2* tws = twl + N;
    const int per_warp = 32 / q, g = lane / q;
    for (int f0 = warp * per_warp; f0 < rb; f0 += WARPS * per_warp) {
      const int f = min(f0 + g, rb - 1);  // a group past rb computes, unwritten
      frame_power_mixed<P>(smem + lay.span + f * hop, pairs, win, tw, twl, tws,
                           q, l, k2, src0, power + f * (N + 1), f0 + g < rb);
    }
  }
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
