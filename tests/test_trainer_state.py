"""Trainer-state checkpointing as one .npz file (save/load round trip)."""
import os

import numpy as np

from cs304_tpu.utils.checkpoint import load_trainer_state, save_trainer_state


def test_npz_roundtrip(tmp_path, rng):
    state = {
        "means_g": rng.normal(size=(3, 5, 4)).astype(np.float32),
        "covs_g": rng.normal(size=(3, 5, 4, 4)).astype(np.float32),
        "iterations_done": np.int32(7),
    }
    folder = str(tmp_path / "ckpt")
    path = save_trainer_state(state, folder)
    assert os.listdir(folder) == ["trainer_state.npz"]  # no temp file left
    assert path == os.path.join(folder, "trainer_state.npz")
    loaded = load_trainer_state(folder)
    assert set(loaded) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(loaded[k], v)
        assert loaded[k].dtype == np.asarray(v).dtype


def test_save_overwrites_previous_state(tmp_path, rng):
    folder = str(tmp_path / "ckpt")
    save_trainer_state({"x": np.zeros(3, np.float32)}, folder)
    save_trainer_state({"x": np.ones(2, np.float32)}, folder)
    np.testing.assert_array_equal(load_trainer_state(folder)["x"],
                                  np.ones(2, np.float32))
