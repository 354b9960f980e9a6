"""Feature-extraction CLI: wav tree -> the reference's precomputed-feature
layouts.

The reference consumes features produced by an upstream librosa/TF pipeline
that is NOT in its repo (KWS_10_log_mel_3000 .npy dirs, nsga_penalty.py:157;
BirdCLEF mel_spec.h5, sa_nsga_penalty.py:58). This command closes that gap
with the port's frontend (frontend/features.py; on CUDA the hand-written
fused kernels of frontend/cuda_kernels.py):

    python -m cmoop_audio_processing_torch.cli.extract_features \\
        --wav-dir birdclef_wavs/ --layout npy --out data_npy/ \\
        --kind log_mel --duration 5 --split 0.7 0.15 0.15 [--device cpu]

Expects <wav-dir>/<class_name>/*.wav; emits either the npy layout
(X_train.npy, y_train.npy, ... with stratified splits) or a single HDF5
(X_train/y_train/classes) matching the loaders in data/loaders.py. Clips are
padded/trimmed to --duration seconds at --sr (after resampling if needed).
The parser is the JAX package's (cmoop_audio_processing_tpu/cli/
extract_features.py) plus ``--device {cuda,cpu}`` (default cuda); for the
same wavs and seed the npy files hold the same rows in the same order.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Tuple

import numpy as np

IN_FLIGHT = 8  # batches the card may hold before the oldest is brought back


def collect_wavs(wav_dir: str) -> Tuple[List[str], List[int], List[str]]:
    classes = sorted(
        d for d in os.listdir(wav_dir)
        if os.path.isdir(os.path.join(wav_dir, d)) and not d.startswith("_")
    )
    paths, labels = [], []
    for ci, cls in enumerate(classes):
        for f in sorted(os.listdir(os.path.join(wav_dir, cls))):
            if f.lower().endswith(".wav"):
                paths.append(os.path.join(wav_dir, cls, f))
                labels.append(ci)
    return paths, labels, classes


def load_clip(path: str, sr: int, n_samples: int) -> np.ndarray:
    from ..frontend.audio_io import load_wav, resample

    y, file_sr = load_wav(path)
    if file_sr != sr:
        y = resample(y, file_sr, sr)
    if len(y) < n_samples:
        y = np.pad(y, (0, n_samples - len(y)))
    return y[:n_samples]


def split_indices(labels, split, seed: int):
    """(train, val, test) row indices of the npy layout: ``split`` is the
    (train, val, test) fractions, stratified by label."""
    from ..data.loaders import three_way_split

    _, va, te = split
    return three_way_split(labels, va + te, te / (va + te), seed)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cmoop-torch-extract-features")
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--layout", choices=["npy", "hdf5"], default="npy")
    p.add_argument("--kind", choices=["log_mel", "mfcc"], default="log_mel")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--duration", type=float, default=1.0)
    p.add_argument("--n-fft", type=int, default=512)
    p.add_argument("--hop", type=int, default=160)
    p.add_argument("--n-mels", type=int, default=40)
    p.add_argument("--n-mfcc", type=int, default=13)
    p.add_argument("--log", choices=["db", "natural"], default="db")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for the JAX CLI's command lines and has no "
                        "effect: on CUDA the fused kernels always run")
    p.add_argument("--split", type=float, nargs=3, default=[0.7, 0.15, 0.15],
                   metavar=("TRAIN", "VAL", "TEST"))
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the frontend (default cuda)")
    return p


def main(argv=None) -> int:
    from ..frontend.features import FrontendConfig, extract_features_device

    args = build_parser().parse_args(argv)
    if abs(sum(args.split) - 1.0) > 1e-6:
        raise SystemExit("--split fractions must sum to 1")
    paths, labels, classes = collect_wavs(args.wav_dir)
    if not paths:
        raise SystemExit(f"no wav files under {args.wav_dir}")
    print(f"{len(paths)} clips across {len(classes)} classes: {classes}")

    n_samples = int(args.sr * args.duration)
    cfg = FrontendConfig(
        sr=args.sr, n_fft=args.n_fft, hop_length=args.hop,
        n_mels=args.n_mels, n_mfcc=args.n_mfcc, log=args.log,
    )

    # Pipelined extraction: extract_features_device returns without waiting
    # for the card, so decoding the NEXT chunk's wavs on the host overlaps
    # the card computing THIS one. A chunk IN_FLIGHT batches behind the
    # newest is brought to the host as we go, so device memory stays
    # bounded whatever the corpus size.
    feats: list = []
    for start in range(0, len(paths), args.batch):
        chunk = paths[start : start + args.batch]
        wavs = np.stack([load_clip(pth, args.sr, n_samples) for pth in chunk])
        feats.append(
            extract_features_device(wavs, cfg, kind=args.kind,
                                    device=args.device)
        )
        if len(feats) > IN_FLIGHT:
            feats[-(IN_FLIGHT + 1)] = feats[-(IN_FLIGHT + 1)].cpu().numpy()
        print(f"  dispatched {min(start + args.batch, len(paths))}/{len(paths)}")
    x = np.concatenate([
        f if isinstance(f, np.ndarray) else f.cpu().numpy() for f in feats
    ]).astype(np.float32)
    y = np.asarray(labels, np.int32)

    if args.layout == "npy":
        from ..data.loaders import save_npy_dir

        train, val, test = split_indices(y, args.split, args.seed)
        save_npy_dir(
            {
                "x_train": x[train], "y_train": y[train],
                "x_val": x[val], "y_val": y[val],
                "x_test": x[test], "y_test": y[test],
            },
            args.out,
        )
        print(f"npy layout written to {args.out}")
    else:
        import h5py

        os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
        with h5py.File(args.out, "w") as hf:
            # the HDF5 layout stores the unsplit pool; load_hdf5 re-splits
            # 50/25/25 (sa_nsga_penalty.py:71-85)
            hf["X_train"] = x
            hf["y_train"] = y
            hf["classes"] = np.array([c.encode() for c in classes])
        print(f"hdf5 written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
