"""Synthesize a GSC-v2-shaped keyword-spotting wav corpus: 10 command
classes of 1-s clips at 16 kHz — the reference's PRIMARY dataset shape
point (nsga_penalty.py:157 consumes ``KWS_10_log_mel_3000`` .npy features;
the upstream audio + extraction pipeline is not in its repo, SURVEY.md §0).

Each class is a formant-synthesized pseudo-word (glottal-harmonic vowels,
band-shaped fricatives, stop gaps + bursts) modeled on the Speech Commands
vocabulary. Classes deliberately SHARE phonemes (no/go end in the same
vowel, on/off start with it, up/stop share the AH+P coda), and each clip
jitters speaker identity (vocal-tract formant scale, f0, speaking rate),
word placement, and noise floor (SNR ~5-25 dB) — so the corpus has a
genuine Bayes floor and Keras-semantics early stopping fires at realistic
epochs instead of every candidate training to the cap (same design as
make_birdclef_corpus.py).

The port's copy of examples/make_kws_corpus.py, with only its imports
changed: the same seed, arguments and bytes.

Usage: python -m cmoop_audio_processing_torch.examples.make_kws_corpus [out_dir] [n_per_class]
(default 120/class; the round-5 realistic-volume run used 3000/class =
30,000 clips ≈ 8.3 h of audio, matching the reference dir name's volume)
"""
import os
import sys

import numpy as np

from ..frontend.audio_io import save_wav

SR = 16000
DUR = 1.0
N_PER_CLASS = 120

# phoneme inventory: ("v", (F1, F2, F3), dur_s) voiced vowels/glides,
# ("f", (band_lo, band_hi), dur_s) fricatives, ("s", burst_hi, dur_s) stops
# (closure gap + broadband burst), ("n", (F1, F2), dur_s) nasals.
PH = {
    "IY": ("v", (270, 2290, 3010), 0.13),
    "EH": ("v", (530, 1840, 2480), 0.14),
    "AH": ("v", (640, 1190, 2390), 0.13),
    "OW": ("v", (570, 840, 2410), 0.18),
    "UW": ("v", (300, 870, 2240), 0.14),
    "AO": ("v", (570, 840, 2410), 0.16),
    "Y": ("v", (270, 2100, 3010), 0.06),
    "L": ("v", (360, 1300, 2700), 0.07),
    "R": ("v", (420, 1300, 1600), 0.07),
    "W": ("v", (300, 610, 2200), 0.06),
    "S": ("f", (4000, 7600), 0.12),
    "SH": ("f", (2000, 5500), 0.11),
    "F": ("f", (1500, 7000), 0.09),
    "N": ("n", (250, 2500), 0.09),
    "T": ("s", 4500, 0.05),
    "P": ("s", 1200, 0.05),
    "D": ("s", 3200, 0.04),
    "G": ("s", 1800, 0.04),
    "K": ("s", 2400, 0.05),
    "B": ("s", 900, 0.04),
}

# the 10-command vocabulary as phoneme sequences (confusable by design)
WORDS = [
    ("yes", ["Y", "EH", "S"]),
    ("no", ["N", "OW"]),
    ("up", ["AH", "P"]),
    ("down", ["D", "AH", "UW", "N"]),
    ("left", ["L", "EH", "F", "T"]),
    ("right", ["R", "AH", "IY", "T"]),
    ("on", ["AO", "N"]),
    ("off", ["AO", "F"]),
    ("stop", ["S", "T", "AH", "P"]),
    ("go", ["G", "OW"]),
]


def _voiced(formants, dur, f0, fscale, rng, nasal=False):
    """Additive glottal-harmonic synthesis: harmonics of a declining-f0
    source, weighted by gaussian formant resonances."""
    n = max(int(dur * SR), 8)
    t = np.arange(n) / SR
    f0_curve = f0 * (1.0 - 0.18 * t / max(dur, 1e-3))  # falling pitch
    phase0 = 2 * np.pi * np.cumsum(f0_curve) / SR
    y = np.zeros(n)
    n_harm = int(4500 / f0)
    fs = np.asarray(formants, float) * fscale
    bw = np.array([90.0, 140.0, 220.0])[: len(fs)]
    for h in range(1, n_harm + 1):
        fh = h * f0
        w = np.sum(np.exp(-0.5 * ((fh - fs) / bw) ** 2)) + 0.03 / h
        if nasal:
            w *= 0.45 if fh > 500 else 1.0
        y += w * np.sin(h * phase0 + rng.uniform(0, 2 * np.pi))
    env = np.sin(np.pi * np.arange(n) / n) ** 0.7
    return y * env


def _fricative(band, dur, fscale, rng):
    n = max(int(dur * SR), 8)
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1 / SR)
    lo, hi = band[0] * fscale, min(band[1] * fscale, SR / 2 - 200)
    mask = np.exp(-0.5 * ((freqs - (lo + hi) / 2) / ((hi - lo) / 2.2)) ** 2)
    y = np.fft.irfft(spec * mask, n)
    env = np.sin(np.pi * np.arange(n) / n) ** 0.5
    return y * env * 0.9


def _stop(burst_hi, dur, fscale, rng):
    gap = np.zeros(int(0.65 * dur * SR))
    nb = max(int(0.35 * dur * SR), 8)
    spec = np.fft.rfft(rng.standard_normal(nb))
    freqs = np.fft.rfftfreq(nb, 1 / SR)
    mask = np.exp(-0.5 * ((freqs - burst_hi * fscale) / 1500.0) ** 2)
    burst = np.fft.irfft(spec * mask, nb)
    burst *= np.exp(-np.arange(nb) / (0.012 * SR)) * 1.6
    return np.concatenate([gap, burst])


def make_word(ci, rng):
    """One utterance of WORDS[ci] with per-clip speaker jitter."""
    f0 = rng.uniform(95, 245)  # speaker pitch
    fscale = rng.uniform(0.88, 1.15)  # vocal-tract length
    rate = rng.uniform(0.8, 1.3)
    segs = []
    for ph in WORDS[ci][1]:
        kind, spec, dur = PH[ph]
        dur = dur * rate * rng.uniform(0.82, 1.22)
        if kind == "v":
            s = _voiced(spec, dur, f0 * 2 ** rng.uniform(-0.1, 0.1),
                        fscale, rng)
        elif kind == "n":
            s = _voiced(spec, dur, f0, fscale, rng, nasal=True)
        elif kind == "f":
            s = _fricative(spec, dur, fscale, rng)
        else:
            s = _stop(spec, dur, fscale, rng)
        peak = np.abs(s).max() + 1e-9
        segs.append(s / peak * rng.uniform(0.55, 1.0))
        segs.append(np.zeros(int(rng.uniform(0.0, 0.015) * SR)))
    return np.concatenate(segs[:-1])


def make_clip(ci, rng):
    n = int(DUR * SR)
    y = rng.standard_normal(n) * 10 ** (rng.uniform(-1.34, -0.76))  # floor
    w = make_word(ci, rng)
    if len(w) > n:
        w = w[:n]
    amp = 10 ** rng.uniform(-0.55, 0.0)
    pos = int(rng.uniform(0, n - len(w)))
    y[pos : pos + len(w)] += amp * w
    # background babble: a fragment of a random OTHER word at comparable
    # amplitude (GSC clips carry background speech; also keeps the corpus
    # from being linearly separable at realistic volume)
    if rng.uniform() < 0.35:
        other = int(rng.integers(0, len(WORDS) - 1))
        if other >= ci:
            other += 1
        frag = make_word(other, rng)
        cut = max(int(len(frag) * rng.uniform(0.3, 0.8)), 8)
        frag = frag[:cut] if rng.uniform() < 0.5 else frag[-cut:]
        if len(frag) > n:
            frag = frag[:n]
        bamp = 10 ** rng.uniform(-1.05, -0.55)
        bpos = int(rng.uniform(0, n - len(frag)))
        y[bpos : bpos + len(frag)] += bamp * frag
    peak = np.abs(y).max()
    return (y / peak * 0.8).astype(np.float32)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/kws_wavs"
    n_per_class = int(sys.argv[2]) if len(sys.argv) > 2 else N_PER_CLASS
    rng = np.random.default_rng(20260820)
    for ci, (word, _) in enumerate(WORDS):
        cdir = os.path.join(out, word)
        os.makedirs(cdir, exist_ok=True)
        for j in range(n_per_class):
            save_wav(os.path.join(cdir, f"clip_{j:04d}.wav"),
                     make_clip(ci, rng), SR)
        print(f"class {word}: {n_per_class} clips", flush=True)
    print(f"wrote {len(WORDS) * n_per_class} wavs under {out}")


if __name__ == "__main__":
    main()
