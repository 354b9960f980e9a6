"""The frontend kernels' two routes, on the CPU.

* Any n_fft: at n_fft values that are not powers of two (the kernels'
  dense route on the card) the port's plain versions and its extraction
  entry points equal the JAX package's XLA chain and its Pallas kernels
  (interpret mode).
* The FFT route's host operands: the CSR mel bank rebuilds the filter bank
  exactly, the window and twiddle tables hold what they should, and an
  emulation of the kernel's packed real FFT (csrc/mel_fft.cuh, the same
  index arithmetic and table reads: a P-point FFT in each lane's registers,
  a twiddle, a Q-point FFT across lanes, the real split; on the radix-2
  plan through bit-reversed writes, on the mixed plan by its radix-5/3/4/2
  stages and the partner lane's registers) built on those tables equals
  torch.fft.rfft of the windowed frame.
* Which n_fft takes which route, and that the Python size list is the
  header's dispatch list.
"""

import os
import re

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.frontend import cuda_kernels as tk
from cmoop_audio_processing_torch.frontend import features as tf
from cmoop_audio_processing_tpu.frontend import features as jf
from cmoop_audio_processing_tpu.frontend.pallas_kernels import (
    log_mel_fused,
    mfcc_fused,
)

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

TOL = dict(atol=3e-2, rtol=1e-3)  # the Pallas-vs-XLA tolerance
KWS = dict(hop_length=360, n_mels=40, n_mfcc=13)


def _signals(n_samples=16000):
    rng = np.random.default_rng(11)
    t = np.arange(n_samples) / 16000.0
    return np.stack([
        0.5 * np.sin(2 * np.pi * 440.0 * t),
        0.3 * np.sin(2 * np.pi * 3000.0 * t) + 0.05 * rng.standard_normal(n_samples),
        0.1 * rng.standard_normal(n_samples),
    ]).astype(np.float32)


@pytest.mark.parametrize("n_fft", [400, 480, 401, 320])
def test_mfcc_at_any_n_fft_matches_jax(n_fft):
    """The fault this pins: the port refused any n_fft that is not a
    multiple of 32 (and framed an odd n_fft one frame too many), where the
    JAX package takes it. 400, 480 and 320 take the mixed-radix FFT route
    on the card, 401 the dense one."""
    ys = _signals()
    cfg = dict(KWS, n_fft=n_fft)
    want = np.asarray(jf.mfcc(ys, jf.FrontendConfig(**cfg)))
    pallas = np.asarray(mfcc_fused(ys, jf.FrontendConfig(**cfg)))
    got = tf.extract_features(ys, tf.FrontendConfig(**cfg), kind="mfcc",
                              device="cpu")
    plain = tk.mfcc_fused_reference(torch.as_tensor(ys),
                                    tf.FrontendConfig(**cfg)).numpy()
    assert got.shape == want.shape == pallas.shape == plain.shape
    for port in (got, plain):
        np.testing.assert_allclose(port, want, **TOL)
        np.testing.assert_allclose(port, pallas, **TOL)


@pytest.mark.parametrize("n_fft,log", [(400, "db"), (480, "db"), (400, "natural"),
                                       (401, "db"), (640, "db")])
def test_log_mel_at_any_n_fft_matches_jax(n_fft, log):
    ys = _signals()
    cfg = dict(n_fft=n_fft, log=log)
    want = np.asarray(jf.log_mel(ys, jf.FrontendConfig(**cfg)))
    pallas = np.asarray(log_mel_fused(ys, jf.FrontendConfig(**cfg)))
    got = tf.extract_features(ys, tf.FrontendConfig(**cfg), kind="log_mel",
                              device="cpu")
    plain = tk.log_mel_fused_reference(torch.as_tensor(ys),
                                       tf.FrontendConfig(**cfg)).numpy()
    assert got.shape == want.shape == pallas.shape == plain.shape
    for port in (got, plain):
        np.testing.assert_allclose(port, want, **TOL)
        np.testing.assert_allclose(port, pallas, **TOL)


def test_extraction_cli_takes_n_fft_400(tmp_path):
    from cmoop_audio_processing_torch.cli import extract_features as tcli
    from cmoop_audio_processing_torch.data.loaders import load_npy_dir
    from cmoop_audio_processing_torch.frontend.audio_io import save_wav

    rng = np.random.default_rng(0)
    t = np.arange(4000) / 16000.0
    for k in range(3):
        (tmp_path / "wavs" / f"c{k}").mkdir(parents=True)
        for i in range(8):
            y = 0.4 * np.sin(2 * np.pi * (600.0 + 1200.0 * k) * t)
            save_wav(str(tmp_path / "wavs" / f"c{k}" / f"{i}.wav"),
                     y + 0.02 * rng.standard_normal(len(t)), 16000)
    assert tcli.main(["--wav-dir", str(tmp_path / "wavs"), "--kind", "mfcc",
                      "--n-fft", "400", "--duration", "0.25", "--out",
                      str(tmp_path / "npy"), "--device", "cpu"]) == 0
    x = load_npy_dir(str(tmp_path / "npy"))["x_train"]
    assert x.shape[1:] == (26, 13) and np.isfinite(x).all()


CONFIGS = {
    "birdclef": tf.FrontendConfig(),
    "kws": tf.FrontendConfig(**KWS),
    "fmin50_fmax7000_64mels": tf.FrontendConfig(fmin=50.0, fmax=7000.0, n_mels=64),
    "empty_bands_256x128": tf.FrontendConfig(n_fft=256, n_mels=128),
    "wide_bands_2048": tf.FrontendConfig(n_fft=2048, n_mels=20),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mel_csr_rebuilds_the_filter_bank_exactly(name):
    cfg = CONFIGS[name]
    csr, weights = tk.mel_csr(cfg)
    assert csr.dtype == np.int32 and weights.dtype == np.float32
    assert sorted(csr[3]) == list(range(cfg.n_mels))  # an order of the bands
    assert (np.diff(csr[1][csr[3]]) <= 0).all()  # longest first
    rebuilt = np.zeros((cfg.n_mels, cfg.n_bins), np.float32)
    for m, (start, length, offset) in enumerate(csr[:3].T):
        rebuilt[m, start:start + length] = weights[offset:offset + length]
    want = tf.mel_matrix(cfg)
    np.testing.assert_array_equal(rebuilt, want)
    assert len(weights) == csr[1].sum()
    if name == "empty_bands_256x128":
        assert (csr[1] == 0).any()
    if name == "wide_bands_2048":
        assert csr[1].max() > 2


def _csr_mel(power, csr, weights):
    """mel_fft.cuh mel_band: each band sums its own bin range in order."""
    out = torch.zeros(power.shape[0], csr.shape[1], dtype=power.dtype)
    for m, (start, length, offset) in enumerate(csr[:3].T):
        for i in range(length):
            out[:, m] += power[:, start + i] * float(weights[offset + i])
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sparse_mel_product_equals_the_dense_one(name):
    cfg = CONFIGS[name]
    rng = np.random.default_rng(5)
    power = torch.as_tensor(rng.random((6, cfg.n_bins)) ** 4, dtype=torch.float32)
    got = _csr_mel(power, *tk.mel_csr(cfg))
    want = power @ torch.as_tensor(tf.mel_matrix(cfg)).T
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


_bitrev = tk.bitrev


def _emulate_fft_power(frames, tables, n):
    """The FFT route's radix-2 frame_power (csrc/mel_fft.cuh) in complex64 torch:
    lane l, register p starts with z[32p + l]; the kernel's exact order of
    stages and table lookups. Returns (frames, n/2 + 1) power."""
    half = n // 2
    p_regs, log2p = half // 32, (half // 32).bit_length() - 1
    win = tables[:n]
    pairs = torch.complex(tables[n::2], tables[n + 1::2])
    tw, tws = pairs[:half], pairs[half:half + half // 2 + 1]
    twl = pairs[half + half // 2 + 1:].reshape(p_regs, 32)
    x = frames * win
    lane = torch.arange(32)
    j = 64 * torch.arange(p_regs)[:, None] + 2 * lane[None, :]
    v = torch.complex(x[:, j], x[:, j + 1])  # (frames, register, lane)
    h = p_regs // 2
    while h >= 1:  # P-point DIF over the registers
        for g in range(0, p_regs, 2 * h):
            for i in range(h):
                a, b = v[:, g + i].clone(), v[:, g + i + h].clone()
                v[:, g + i] = a + b
                v[:, g + i + h] = (a - b) * (tw[i * (half // (2 * h))] if i else 1)
        h //= 2
    for r in range(1, p_regs):  # A[k1] *= W_N^(lane * k1), k1 = bitrev(r)
        v[:, r] = v[:, r] * twl[r]
    for s in range(5):  # 32-point DIF across the lanes (__shfl_xor_sync)
        d = 16 >> s
        upper = (lane & d) != 0
        q = v[:, :, lane ^ d]
        t = torch.where(upper, q - v, v + q)
        v = t * torch.where(upper, tw[(lane % d) * (16 // d) * p_regs],
                            torch.ones((), dtype=tw.dtype))
    z = torch.empty(frames.shape[0], half, dtype=v.dtype)
    k = (torch.tensor([_bitrev(r, log2p) for r in range(p_regs)])[:, None]
         + p_regs * torch.tensor([_bitrev(i, 5) for i in range(32)])[None, :])
    z[:, k] = v
    power = torch.empty(frames.shape[0], half + 1)
    power[:, 0] = (z[:, 0].real + z[:, 0].imag) ** 2
    power[:, half] = (z[:, 0].real - z[:, 0].imag) ** 2
    power[:, half // 2] = z[:, half // 2].abs() ** 2
    k = torch.arange(1, half // 2)
    a, b = z[:, k], z[:, half - k].conj()
    e, o = 0.5 * (a + b), -0.5j * (a - b)
    wo = tws[k] * o
    power[:, half - k] = (e - wo).abs() ** 2
    power[:, k] = (e + wo).abs() ** 2
    return power


def _w(turns):
    """exp(-2 pi i turns) in float64, by its cosine and sine (np.exp rounds
    some zero crossings to other float32 values)."""
    angles = 2.0 * np.pi * np.asarray(turns, np.float64)
    return np.cos(angles) - 1j * np.sin(angles)


_SMALL_DFT = {  # mel_fft.cuh small_dft: the R-point DFT's matrix
    r: torch.as_tensor(np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r))
                              / r), dtype=torch.complex64)
    for r in (2, 3, 4, 5)}


def _dif(v, length, off):
    """mel_fft.cuh dif<P, L, OFF>: registers [off, off + length) of v
    (frames, P, Q), in place, its twiddles W_L^(m s) constants rounded to
    float32 (the kernel's compile-time turn_cos / turn_sin)."""
    if length == 1:
        return
    r = tk.first_radix(length)
    m = length // r
    for i in range(m):
        regs = [off + i + m * j for j in range(r)]
        y = v[:, regs, :].transpose(1, 2) @ _SMALL_DFT[r].T  # (frames, Q, R)
        for s in range(r):
            w = complex(_w(i * s / length).astype(np.complex64)) if i * s else 1
            v[:, regs[s], :] = y[:, :, s] * w
    for s in range(r):
        _dif(v, m, off + m * s)


def _emulate_mixed_power(frames, tables, n):
    """The FFT route's mixed-radix frame_power_mixed (csrc/mel_fft.cuh) in
    complex64 torch: lane l of a group, register p starts with z[Q p + l];
    the kernel's stages and table reads. Returns (frames, n/2 + 1) power."""
    half = n // 2
    p, q = tk.fft_plan(n)
    pairs = torch.complex(tables[n::2], tables[n + 1::2])
    tw = pairs[:half]
    twl = pairs[half:2 * half].reshape(p, q)
    tws = pairs[2 * half:3 * half].reshape(p, q)
    x = frames * tables[:n]
    lane = torch.arange(q)
    j = 2 * (q * torch.arange(p)[:, None] + lane[None, :])
    v = torch.complex(x[:, j], x[:, j + 1])  # (frames, register, lane)
    _dif(v, p, 0)
    v[:, 1:] = v[:, 1:] * twl[1:]  # A[k1] *= W_N^(l * k1)
    for d in (16, 8, 4, 2, 1):  # Q-point DIF across the group's lanes
        if d >= q:
            continue
        upper = (lane & d) != 0
        other = v[:, :, lane ^ d]
        t = torch.where(upper, other - v, v + other)
        v = t * torch.where(upper, tw[(lane % d) * (q // (2 * d)) * p],
                            torch.ones((), dtype=tw.dtype))
    bits = q.bit_length() - 1
    k2 = torch.tensor([_bitrev(i, bits) for i in range(q)])
    src0 = torch.tensor([_bitrev(int(-k) % q, bits) for k in k2])
    power = torch.full((frames.shape[0], half + 1), float("nan"))
    for r in range(p):  # the split, Z[N - k] from the partner lane
        k1 = tk.dif_order(p, r)
        if k1 == 0:
            b = v[:, 0, src0]
        else:
            rp = [tk.dif_order(p, i) for i in range(p)].index(p - k1)
            b = v[:, rp, lane ^ (q - 1)]
        a, b = v[:, r], b.conj()
        e, o = 0.5 * (a + b), -0.5j * (a - b)
        power[:, k1 + p * k2] = (e + tws[r] * o).abs() ** 2
    power[:, half] = (v[:, 0, 0].real - v[:, 0, 0].imag) ** 2
    return power


@pytest.mark.parametrize("n", [64, 512, 2048, 320, 400, 480, 640, 800, 960,
                               72, 100, 384, 1920])
def test_packed_fft_emulation_equals_rfft_of_the_windowed_frame(n):
    """The radix-2 plan at 64, 512 and 2048; the mixed plan at the rest
    (P x Q: 5 x 32, 25 x 8, 15 x 16, 10 x 32, 25 x 16, 15 x 32, 9 x 4,
    25 x 2, 6 x 32, 30 x 32)."""
    rng = np.random.default_rng(n)
    frames = torch.as_tensor(rng.standard_normal((5, n)), dtype=torch.float32)
    cfg = tf.FrontendConfig(n_fft=n)
    tables = torch.as_tensor(tk.fft_tables(cfg))
    p, _ = tk.fft_plan(n)
    emulate = _emulate_fft_power if p & (p - 1) == 0 else _emulate_mixed_power
    got = emulate(frames, tables, n).double()
    spec = torch.fft.rfft(frames.double() * torch.as_tensor(tf.window(cfg)))
    want = spec.abs() ** 2
    assert got.shape == want.shape == (5, n // 2 + 1)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("n,win_length", [(64, None), (512, None), (2048, None),
                                          (512, 400), (400, None), (480, 400),
                                          (960, None), (72, None)])
def test_fft_tables_hold_the_window_and_the_twiddles(n, win_length):
    cfg = tf.FrontendConfig(n_fft=n, win_length=win_length)
    tables = tk.fft_tables(cfg)
    half = n // 2
    p, q = tk.fft_plan(n)
    radix2 = p & (p - 1) == 0
    assert tables.dtype == np.float32 and len(tables) == (
        3 * n + 2 * (n // 4 + 1) if radix2 else 4 * n)
    win = tables[:n]
    np.testing.assert_array_equal(win, tf.window(cfg).astype(np.float32))
    # the window the dense route folds into its DFT matrix
    np.testing.assert_allclose(tf.dft_matrices(cfg)[:, 0], win, rtol=1e-6)
    if win_length:
        assert (win[:(n - win_length) // 2] == 0).all() and win[-1] == 0
    w_n = _w(np.arange(half) / half)
    np.testing.assert_array_equal(tables[n:n + 2 * half:2], w_n.real.astype(np.float32))
    np.testing.assert_array_equal(tables[n + 1:n + 2 * half:2], w_n.imag.astype(np.float32))
    if not radix2:
        # [r][l]: W_N^(l * k1) and W_n^(k1 + P * bitrev_Q(l)), k1 = the
        # frequency register r holds after the in-register FFT
        k1 = np.array([tk.dif_order(p, r) for r in range(p)])
        assert sorted(k1) == list(range(p))
        k2 = np.array([_bitrev(i, q.bit_length() - 1) for i in range(q)])
        for i, turns in enumerate([np.outer(k1, np.arange(q)) / half,
                                   (k1[:, None] + p * k2[None, :]) / n]):
            w = _w(turns).ravel()
            got = tables[n + 2 * half * (i + 1):n + 2 * half * (i + 2)]
            np.testing.assert_array_equal(got[::2], w.real.astype(np.float32))
            np.testing.assert_array_equal(got[1::2], w.imag.astype(np.float32))
        return
    w_split = _w(np.arange(half // 2 + 1) / n)
    split = tables[n + 2 * half:n + 2 * half + 2 * len(w_split)]
    np.testing.assert_array_equal(split[::2], w_split.real.astype(np.float32))
    np.testing.assert_array_equal(split[1::2], w_split.imag.astype(np.float32))
    regs = half // 32
    k1 = [_bitrev(r, regs.bit_length() - 1) for r in range(regs)]
    w_lane = _w(np.outer(k1, np.arange(32)) / half).ravel()
    lanes = tables[n + 2 * half + 2 * len(w_split):]
    np.testing.assert_array_equal(lanes[::2], w_lane.real.astype(np.float32))
    np.testing.assert_array_equal(lanes[1::2], w_lane.imag.astype(np.float32))


@pytest.mark.parametrize("n_fft,route", [
    (64, "fft"), (128, "fft"), (256, "fft"), (512, "fft"), (1024, "fft"),
    (2048, "fft"), (32, "dense"), (4096, "dense"), (400, "fft"),
    (480, "fft"), (511, "dense"), (401, "dense"), (320, "fft"), (960, "fft"),
    (402, "dense"), (1200, "dense"), (90, "dense"), (1000, "dense"),
    (3840, "dense"),
])
def test_dft_route_takes_the_fft_for_powers_of_two_from_64_to_2048(n_fft, route):
    """The FFT route takes the powers of two from 64 to 2048 and the even
    sizes whose half is 2^a 3^b 5^c with at most 32 points a lane (400 =
    2 x 25 x 8); 401 is odd, 402 = 2 x 3 x 67, and 1200 (N = 75 x 8), 90
    (45 x 1) and 1000 (125 x 4) would hold more than 32 points a lane."""
    assert tk.dft_route(n_fft) == route


def test_fft_sizes_are_the_headers_dispatch_list():
    """FFT_SIZES and each size's P (fft_plan) are the cases of
    csrc/mel_fft.cuh with_plan, read from its source."""
    with open(os.path.join(tk.CSRC_DIR, "mel_fft.cuh")) as f:
        text = f.read()
    body = text[text.index("inline cudaError_t with_plan("):]
    body = body[:body.index("default:")]
    cases = re.findall(
        r"case (\d+): return f\(std::integral_constant<int, (\d+)>\(\)\);",
        body)
    assert [(int(n), int(p)) for n, p in cases] == [
        (n, tk.fft_plan(n)[0]) for n in tk.FFT_SIZES]
    assert {320, 400, 480, 640, 800, 960} <= set(tk.FFT_SIZES)
    assert len(tk.FFT_SIZES) == 36 and tk.FFT_SIZES[0] == 64
    for n in tk.FFT_SIZES:
        p, q = tk.fft_plan(n)
        assert p * q == n // 2 and p <= tk.FFT_MAX_POINTS and 32 % q == 0


def test_any_n_fft_runs_on_the_cpu_and_bad_input_still_raises():
    y = torch.as_tensor(_signals(4000))
    for n_fft in (400, 100, 33, 401):
        cfg = tf.FrontendConfig(n_fft=n_fft, n_mels=16, n_mfcc=8)
        assert tk.mfcc_fused(y, cfg).shape == (3, cfg.n_frames(4000), 8)
        assert tk.log_mel_fused(y, cfg).shape == (3, cfg.n_frames(4000), 16)
    cfg = tf.FrontendConfig(n_fft=400)
    with pytest.raises(ValueError):
        tk.mfcc_fused(y.double(), cfg)
    with pytest.raises(ValueError):
        tk.log_mel_fused(y[:, :150], cfg)
    with pytest.raises(ValueError):
        tk.mfcc_fused(y, tf.FrontendConfig(n_fft=400, n_mels=10, n_mfcc=13))
