"""Synthesize a BirdCLEF-shaped wav corpus: 11 classes of 5-s birdsong-like
clips at 16 kHz — the reference's second dataset shape point
(sa_nsga_penalty.py:38-102: 11 classes, mel_spec.h5, 5-s clips).

Each class is a distinct syllable grammar (carrier band, FM chirp direction
and rate, syllable duration/rhythm, harmonic stack); each clip jitters
pitch, timing, amplitude and noise floor. Two ingredients give the corpus a
genuine Bayes floor (so val_loss has a real minimum and Keras-semantics
early stopping fires at realistic epochs, like on real recordings, instead
of every candidate training to the 300-epoch cap):

* an audible noise floor (SNR roughly 6-20 dB per clip), and
* cross-class distractors: ~45% of clips contain a few syllables from a
  random OTHER species at comparable amplitude (overlapping songs are the
  norm in real soundscape recordings).

The port's copy of examples/make_birdclef_corpus.py, with only its imports
changed: the same seed, arguments and bytes.

Usage: python -m cmoop_audio_processing_torch.examples.make_birdclef_corpus [out_dir] [n_per_class]
(default 120/class = 1320 clips; the round-4 full-scale run used 300/class
= 3300 clips ≈ 4.6 h of audio, a realistic soundscape-subset volume)
"""
import os
import sys

import numpy as np

from ..frontend.audio_io import save_wav

SR = 16000
DUR = 5.0
N_PER_CLASS = 120

# class grammar: (f0 Hz, chirp octaves/syllable, syllable s, gap s, harmonics)
GRAMMAR = [
    (900, +0.6, 0.10, 0.08, 1),
    (1400, -0.5, 0.07, 0.05, 2),
    (2100, +0.3, 0.18, 0.22, 1),
    (2800, -0.8, 0.05, 0.03, 3),
    (700, +0.2, 0.30, 0.40, 2),
    (3600, +0.9, 0.06, 0.10, 1),
    (1100, -0.3, 0.12, 0.30, 3),
    (1800, +0.5, 0.09, 0.04, 2),
    (2500, -0.6, 0.15, 0.15, 1),
    (4200, +0.4, 0.08, 0.25, 2),
    (1600, 0.0, 0.22, 0.10, 3),  # flat whistle
]


def syllable(f0, octaves, dur, harmonics, rng):
    n = int(dur * SR)
    t = np.arange(n) / SR
    f = f0 * 2.0 ** (octaves * t / dur)
    phase = 2 * np.pi * np.cumsum(f) / SR + rng.uniform(0, 2 * np.pi)
    env = np.sin(np.pi * np.arange(n) / n) ** 2
    y = np.zeros(n)
    for h in range(1, harmonics + 1):
        y += np.sin(h * phase) / h
    return y * env


def add_song(y, ci, rng, amp_lo, amp_hi, start_frac, max_syllables=None):
    """Lay one species' syllable sequence into y; returns syllable count."""
    f0, octv, sdur, gap, harm = GRAMMAR[ci]
    n = len(y)
    pitch_jit = 2.0 ** rng.uniform(-0.15, 0.15)
    pos = int(rng.uniform(0, start_frac) * SR)
    count = 0
    while pos < n - int(0.35 * SR):
        if max_syllables is not None and count >= max_syllables:
            break
        d = sdur * rng.uniform(0.8, 1.25)
        s = syllable(f0 * pitch_jit * 2 ** rng.uniform(-0.06, 0.06),
                     octv * rng.uniform(0.7, 1.3), d, harm, rng)
        amp = 10 ** rng.uniform(amp_lo, amp_hi)
        end = min(pos + len(s), n)
        y[pos:end] += amp * s[: end - pos]
        pos = end + int((gap * rng.uniform(0.6, 1.8) + 0.01) * SR)
        count += 1
    return count


def make_clip(ci, rng):
    n = int(DUR * SR)
    # audible noise floor: the old corpus (-2.2..-1.6) was clean enough that
    # val_loss improved monotonically for hundreds of epochs
    y = rng.standard_normal(n) * 10 ** (rng.uniform(-1.35, -0.8))
    add_song(y, ci, rng, amp_lo=-1.15, amp_hi=-0.2, start_frac=0.4)
    if rng.uniform() < 0.45:  # overlapping song from another species
        other = int(rng.integers(0, len(GRAMMAR) - 1))
        if other >= ci:
            other += 1
        add_song(y, other, rng, amp_lo=-1.1, amp_hi=-0.3, start_frac=0.8,
                 max_syllables=int(rng.integers(2, 5)))
    peak = np.abs(y).max()
    return (y / peak * 0.8).astype(np.float32)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/birdclef_wavs"
    n_per_class = int(sys.argv[2]) if len(sys.argv) > 2 else N_PER_CLASS
    rng = np.random.default_rng(20260817)
    for ci in range(len(GRAMMAR)):
        cdir = os.path.join(out, f"species_{ci:02d}")
        os.makedirs(cdir, exist_ok=True)
        for j in range(n_per_class):
            save_wav(os.path.join(cdir, f"clip_{j:03d}.wav"),
                     make_clip(ci, rng), SR)
        print(f"class {ci}: {n_per_class} clips", flush=True)
    print(f"wrote {len(GRAMMAR) * n_per_class} wavs under {out}")


if __name__ == "__main__":
    main()
