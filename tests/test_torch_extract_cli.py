"""The PyTorch port's extraction CLI and its sklearn-free stratified split,
against sklearn and the JAX package's CLI and HDF5 loader."""

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.cli import extract_features as tcli
from cmoop_audio_processing_torch.data import loaders as tloaders
from cmoop_audio_processing_torch.frontend.audio_io import save_wav
from cmoop_audio_processing_tpu.cli import extract_features as jcli
from cmoop_audio_processing_tpu.data import loaders as jloaders

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("n,classes,test_size,seed", [
    (24, 3, 0.3, 42), (528, 11, 0.3, 42), (100, 7, 0.5, 0), (37, 4, 0.45, 5),
    (1000, 11, 0.15, 123), (61, 2, 0.5, 7), (40, 5, 0.3 + 1e-9, 1),
])
def test_stratified_split_equals_sklearn_index_for_index(n, classes, test_size, seed):
    from sklearn.model_selection import train_test_split

    y = np.random.default_rng(n).integers(0, classes, n)
    y[:classes] = np.arange(classes)  # every class present...
    y[classes:2 * classes] = np.arange(classes)  # ...at least twice
    want_train, want_test = train_test_split(
        np.arange(n), test_size=test_size, random_state=seed, stratify=y)
    train, test = tloaders.stratified_split(y, test_size, seed)
    np.testing.assert_array_equal(train, want_train)
    np.testing.assert_array_equal(test, want_test)


def test_stratified_split_refuses_what_sklearn_refuses():
    y = np.array([0, 0, 0, 1, 1, 1, 2])
    with pytest.raises(ValueError, match="only 1 member"):
        tloaders.stratified_split(y, 0.5, 0)
    with pytest.raises(ValueError, match="number of classes"):
        tloaders.stratified_split(np.repeat(np.arange(4), 2), 0.2, 0)


def _wav_tree(root, classes=3, per_class=8, seconds=0.5, sr=16000):
    """A few short class-dependent clips: a tone per class plus noise."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * sr)) / sr
    for k in range(classes):
        (root / f"class_{k}").mkdir(parents=True)
        for i in range(per_class):
            y = 0.4 * np.sin(2 * np.pi * (500.0 + 900.0 * k) * t * rng.uniform(0.98, 1.02))
            save_wav(str(root / f"class_{k}" / f"{i:02d}.wav"),
                     y + 0.02 * rng.standard_normal(len(t)), sr)
    # a file that is not a wav and a hidden class folder are skipped
    (root / "class_0" / "notes.txt").write_text("x")
    (root / "_hidden").mkdir()


@pytest.mark.parametrize("kind,tol", [("log_mel", 2e-2), ("mfcc", 3e-2)])
def test_extraction_cli_writes_the_jax_clis_npy_files(tmp_path, kind, tol):
    """--device cpu on a tiny wav tree: the same files, labels and row
    order as the JAX CLI's, features within the frontend tolerance. A batch
    of 2 clips puts more than 8 batches in flight, so the loop's early
    bring-back runs."""
    _wav_tree(tmp_path / "wavs")
    args = ["--wav-dir", str(tmp_path / "wavs"), "--kind", kind,
            "--duration", "0.5", "--batch", "2", "--seed", "3"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--out", str(tmp_path / "torch"), "--pallas",
                             "--device", "cpu"]) == 0
    want = jloaders.load_npy_dir(str(tmp_path / "jax"))
    got = tloaders.load_npy_dir(str(tmp_path / "torch"))
    frames = 51  # 8000 samples, hop 160, centred
    for key in ("train", "val", "test"):
        np.testing.assert_array_equal(got[f"y_{key}"], want[f"y_{key}"])
        assert got[f"x_{key}"].shape[1:] == (frames, 40 if kind == "log_mel" else 13)
        np.testing.assert_allclose(got[f"x_{key}"], want[f"x_{key}"], atol=tol)
    assert sum(len(got[f"y_{k}"]) for k in ("train", "val", "test")) == 24


def test_extraction_cli_hdf5_layout_loads_like_the_jax_packages(tmp_path):
    pytest.importorskip("h5py")
    _wav_tree(tmp_path / "wavs", per_class=8)
    out = tmp_path / "feats.h5"
    assert tcli.main(["--wav-dir", str(tmp_path / "wavs"), "--duration", "0.5",
                      "--layout", "hdf5", "--out", str(out),
                      "--device", "cpu"]) == 0
    got = tloaders.load_hdf5(str(out))
    want = jloaders.load_hdf5(str(out))
    assert got["classes"] == want["classes"] == ["class_0", "class_1", "class_2"]
    for key in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        np.testing.assert_array_equal(got[key], want[key])


def test_extraction_cli_refuses_bad_input(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no wav files"):
        tcli.main(["--wav-dir", str(tmp_path / "empty"), "--out", "x",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="sum to 1"):
        tcli.main(["--wav-dir", str(tmp_path / "empty"), "--out", "x",
                   "--split", "0.5", "0.3", "0.3", "--device", "cpu"])
