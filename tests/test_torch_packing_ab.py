"""The port's stop-epoch packing A/B (cmoop_audio_processing_torch/
examples/packing_ab.py, the JAX package's examples/packing_ab.py ported)
at a toy size on the CPU."""

import torch

from cmoop_audio_processing_torch.core.config import DataConfig
from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
from cmoop_audio_processing_torch.examples import packing_ab

# the test workers share the CPU's cores: one intra-op thread per worker
torch.set_num_threads(1)


def test_both_arms_give_bit_equal_fitness_on_the_cpu():
    """Four of the script's genomes, 2 epochs, ``AB_MAXM`` 2, one rep on
    32 rows: two 2-lane launches an evaluate in each arm, and the packed
    and unpacked arms give each genome of the shuffled input the same
    fitness bit for bit (on the CPU a genome's bits do not depend on the
    lanes that share its launch)."""
    data = prepare_dataset(DataConfig(num_classes=10, synthetic_train=32,
                                      synthetic_eval=16, time_steps=16,
                                      features=9))
    genomes = packing_ab.ab_genomes()
    assert len(genomes) == 16
    out = packing_ab.run_ab(data, genomes[::4], epochs=2, reps=1, maxm=2,
                            device="cpu")
    assert out["config"] == {"epochs": 2, "max_models_per_program": 2,
                             "reps": 1, "genomes": 4, "device": "cpu"}
    assert len(out["stop_epochs"]) == 4
    assert len(out["off_s"]) == len(out["on_s"]) == 1
    assert out["max_fitness_drift"] == [0.0]
    for rep in out["fitness"]:
        assert rep["off"] == rep["on"] and len(rep["on"]) == 4
    assert out["card"] is None
