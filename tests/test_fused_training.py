"""Parity tests: fused single-program embedded training vs the legacy path.

The fused iteration (cs304_tpu/models/train_fused.py) must produce the same
trained parameters, the same convergence iteration, and the same failure
behavior as the legacy per-transcript path (train_continuous._iteration),
which is itself the reference-parity implementation of
hidden_markov_model.py:584-797."""
import numpy as np
import pytest

from cs304_tpu.models.hmm import WordHMM, uniform_forward_log_a
from cs304_tpu.models.train_continuous import (
    ContinuousTrainConfig,
    ContinuousTrainer,
    HMMTrainMeanFail,
)

D = 6


def _models(rng, labels=("1", "2", "3", "S")):
    out = {}
    for label in labels:
        s = 3 if label == "S" else 5
        means = rng.normal(size=(s, D)).astype(np.float32) * 3
        a = rng.normal(size=(s, D, 3)).astype(np.float32) * 0.2
        covs = a @ np.transpose(a, (0, 2, 1)) + 0.4 * np.eye(D, dtype=np.float32)
        out[label] = WordHMM(
            label=label, means=means, covariances=covs,
            log_a=uniform_forward_log_a(s),
        )
    return out


def _copy(models):
    return {
        k: WordHMM(label=v.label, means=v.means.copy(),
                   covariances=v.covariances.copy(), log_a=v.log_a.copy())
        for k, v in models.items()
    }


def _corpus(models, transcripts, n_per, seed=1, spread=0.5):
    r = np.random.default_rng(seed)
    labeled = {}
    for tr in transcripts:
        sentence = "S" + "S".join(tr) + "S"
        feats = []
        for _ in range(n_per):
            frames = []
            for w in sentence:
                m = models[w]
                for si in range(m.num_states):
                    n = r.integers(2, 5)
                    frames.append(
                        m.means[si] + r.normal(0, spread, size=(n, D)).astype(np.float32)
                    )
            feats.append(np.concatenate(frames).astype(np.float32))
        labeled[tr] = feats
    return labeled


def _train(models, labeled, fused, **kw):
    cfg = ContinuousTrainConfig(
        max_iterations=kw.pop("max_iterations", 4),
        silence_bootstrap=kw.pop("silence_bootstrap", False),
        cov_reg=0.05, fused=fused, length_multiple=16, **kw,
    )
    tr = ContinuousTrainer(_copy(models), cfg)
    n_it = tr.train(labeled)
    return n_it, tr


def _assert_params_match(a, b, tol=2e-5):
    for name in ("means_g", "covs_g", "log_a_g"):
        x, y = getattr(a, name), getattr(b, name)
        assert (np.isfinite(x) == np.isfinite(y)).all(), name
        fin = np.isfinite(x)
        np.testing.assert_allclose(x[fin], y[fin], atol=tol, rtol=1e-4,
                                   err_msg=name)


def test_fused_matches_legacy_params_and_iterations(rng):
    models = _models(rng)
    labeled = _corpus(models, ["12", "321", "13"], 5)
    n_legacy, tr_legacy = _train(models, labeled, fused=False)
    n_fused, tr_fused = _train(models, labeled, fused=True)
    assert n_legacy == n_fused
    _assert_params_match(tr_legacy, tr_fused)


def test_fused_matches_legacy_with_bootstrap(rng):
    models = _models(rng)
    labeled = _corpus(models, ["12", "321"], 6, seed=3)
    n_legacy, tr_legacy = _train(models, labeled, fused=False,
                                 silence_bootstrap=True)
    n_fused, tr_fused = _train(models, labeled, fused=True,
                               silence_bootstrap=True)
    assert n_legacy == n_fused
    _assert_params_match(tr_legacy, tr_fused)


def test_fused_matches_legacy_band_topology(rng):
    models = _models(rng)
    labeled = _corpus(models, ["12", "321"], 4, seed=5)
    n_legacy, tr_legacy = _train(models, labeled, fused=False,
                                 cross_word="band")
    n_fused, tr_fused = _train(models, labeled, fused=True, cross_word="band")
    assert n_legacy == n_fused
    _assert_params_match(tr_legacy, tr_fused)


def test_fused_ragged_sentences_and_odd_utterance_counts(rng):
    """Mixed sentence lengths + utterance counts that don't divide the chunk."""
    models = _models(rng)
    labeled = _corpus(models, ["1", "32", "123", "2131"], 3, seed=7)
    # drop one utterance to make the total odd
    labeled["1"] = labeled["1"][:2]
    n_legacy, tr_legacy = _train(models, labeled, fused=False)
    n_fused, tr_fused = _train(models, labeled, fused=True)
    assert n_legacy == n_fused
    _assert_params_match(tr_legacy, tr_fused)


def test_fused_sharded_matches_single_device(rng):
    """The mesh-sharded fused iteration (psum'd statistics over an 8-device
    virtual mesh) must train to the same parameters in the same number of
    iterations as the single-device fused program."""
    from cs304_tpu.parallel.data_parallel import make_mesh

    models = _models(rng)
    labeled = _corpus(models, ["12", "321", "13"], 5, seed=13)
    n_single, tr_single = _train(models, labeled, fused=True)

    cfg = ContinuousTrainConfig(
        max_iterations=4, silence_bootstrap=False, cov_reg=0.05,
        fused=True, length_multiple=16,
    )
    tr_mesh = ContinuousTrainer(_copy(models), cfg, mesh=make_mesh())
    n_mesh = tr_mesh.train(labeled)
    assert n_single == n_mesh
    tr_mesh.models()  # force device->host sync
    _assert_params_match(tr_single, tr_mesh)


def test_fused_sharded_bootstrap(rng):
    """Silence bootstrap reads back sharded paths; must match single-device."""
    from cs304_tpu.parallel.data_parallel import make_mesh

    models = _models(rng)
    labeled = _corpus(models, ["12", "321"], 6, seed=3)
    n_single, tr_single = _train(models, labeled, fused=True,
                                 silence_bootstrap=True)
    cfg = ContinuousTrainConfig(
        max_iterations=4, silence_bootstrap=True, cov_reg=0.05,
        fused=True, length_multiple=16,
    )
    tr_mesh = ContinuousTrainer(_copy(models), cfg, mesh=make_mesh())
    n_mesh = tr_mesh.train(labeled)
    assert n_single == n_mesh
    tr_mesh.models()
    _assert_params_match(tr_single, tr_mesh)


def test_fused_baum_welch_matches_legacy(rng):
    """Fused Baum-Welch (banded whole-batch forward-backward, soft counts)
    must match the legacy per-transcript BW path (_stats_pass_bw +
    _centered_m2_pass_weighted)."""
    models = _models(rng)
    labeled = _corpus(models, ["12", "321", "13"], 5, seed=17)
    n_legacy, tr_legacy = _train(models, labeled, fused=False,
                                 update="baum_welch")
    n_fused, tr_fused = _train(models, labeled, fused=True,
                               update="baum_welch")
    assert n_legacy == n_fused
    _assert_params_match(tr_legacy, tr_fused, tol=5e-5)


def test_fused_baum_welch_sharded_matches_single(rng):
    from cs304_tpu.parallel.data_parallel import make_mesh

    models = _models(rng)
    labeled = _corpus(models, ["12", "321"], 5, seed=19)
    n_single, tr_single = _train(models, labeled, fused=True,
                                 update="baum_welch")
    cfg = ContinuousTrainConfig(
        max_iterations=4, silence_bootstrap=False, cov_reg=0.05,
        fused=True, length_multiple=16, update="baum_welch",
    )
    tr_mesh = ContinuousTrainer(_copy(models), cfg, mesh=make_mesh())
    n_mesh = tr_mesh.train(labeled)
    assert n_single == n_mesh
    tr_mesh.models()
    _assert_params_match(tr_single, tr_mesh)


def test_quad_emissions_trains_close_to_whiten(rng):
    """emissions='quad' (the K=1521 quadratic form, ~1e-2 emission
    error) must train to parameters close to the exact whitening path —
    alignment argmax decisions only differ on exact near-ties."""
    models = _models(rng)
    labeled = _corpus(models, ["12", "321", "13"], 5, seed=23)
    _, tr_w = _train(models, labeled, fused=True)
    _, tr_q = _train(models, labeled, fused=True, emissions="quad")
    for name in ("means_g", "covs_g"):
        x, y = getattr(tr_w, name), getattr(tr_q, name)
        np.testing.assert_allclose(x, y, atol=5e-2, rtol=5e-2, err_msg=name)


def test_device_loop_matches_per_iteration_path(rng, tmp_path):
    """train() without checkpointing uses the whole-run lax.while_loop
    (one dispatch); with a checkpoint_dir it must fall back to the
    per-iteration path — both must produce identical results."""
    models = _models(rng)
    labeled = _corpus(models, ["12", "321"], 5, seed=21)
    cfg = ContinuousTrainConfig(
        max_iterations=4, silence_bootstrap=False, cov_reg=0.05,
        fused=True, length_multiple=16,
    )
    tr_loop = ContinuousTrainer(_copy(models), cfg)
    n_loop = tr_loop.train(labeled)  # device loop
    tr_step = ContinuousTrainer(_copy(models), cfg)
    n_step = tr_step.train(labeled, checkpoint_dir=str(tmp_path / "ck"))
    assert n_loop == n_step
    _assert_params_match(tr_loop, tr_step, tol=0)


def test_fused_empty_state_fail(rng):
    """A label that never appears in any transcript must trigger the
    reference's HMMTrainMeanFail under on_empty_state='fail'."""
    models = _models(rng)
    labeled = _corpus(models, ["12"], 3, seed=9)  # label "3" gets no frames
    with pytest.raises(HMMTrainMeanFail):
        _train(models, labeled, fused=True, on_empty_state="fail",
               max_iterations=1)


def test_fused_models_and_checkpoint_reflect_device_state(rng, tmp_path):
    """models()/save_state() must expose the device-resident parameters."""
    models = _models(rng)
    labeled = _corpus(models, ["12", "31"], 4, seed=11)
    _, tr = _train(models, labeled, fused=True, max_iterations=2)
    out = tr.models()
    assert np.allclose(out["1"].means, tr.means_g[tr.label_index["1"], :5])
    # save/resume round trip
    tr.save_state(str(tmp_path / "ckpt"))
    _, tr2 = _train(models, labeled, fused=True, max_iterations=0)
    tr2.resume(str(tmp_path / "ckpt"))
    _assert_params_match(tr, tr2, tol=0)


# -- one-spine combo matrix (VERDICT r2 #2) -----------------------------------

@pytest.fixture(scope="module")
def _matrix_setup():
    rng = np.random.default_rng(7)
    models = _models(rng)
    labeled = _corpus(models, ["12", "31", "123"], n_per=3)
    return models, labeled


@pytest.mark.parametrize("update", ["viterbi", "baum_welch"])
@pytest.mark.parametrize("use_mesh", [False, True])
@pytest.mark.parametrize("use_ckpt", [False, True])
def test_trainer_combo_matrix(_matrix_setup, update, use_mesh, use_ckpt,
                              tmp_path):
    """The fused spine is THE production path: every (update x mesh x
    checkpoint) combo must run and land on the same parameters and iteration
    count as the plain single-host fused run."""
    from cs304_tpu.parallel.data_parallel import make_mesh

    models, labeled = _matrix_setup
    cfg = ContinuousTrainConfig(
        max_iterations=4, silence_bootstrap=False, cov_reg=0.05,
        length_multiple=16, update=update,
    )
    base = ContinuousTrainer(_copy(models), cfg)
    n_base = base.train(labeled)
    base.models()

    tr = ContinuousTrainer(
        _copy(models), cfg, mesh=make_mesh() if use_mesh else None
    )
    n = tr.train(
        labeled,
        checkpoint_dir=str(tmp_path / "ck") if use_ckpt else None,
    )
    tr.models()
    assert n == n_base
    _assert_params_match(base, tr)
    if use_ckpt:
        # Resume from the checkpoint continues without re-running history.
        tr2 = ContinuousTrainer(
            _copy(models), cfg, mesh=make_mesh() if use_mesh else None
        )
        assert tr2.resume(str(tmp_path / "ck")) == n


def test_legacy_oracle_is_single_host_only():
    """fused=False is the parity oracle: combining it with a mesh is a
    construction-time error (no mid-iteration NotImplementedError)."""
    from cs304_tpu.parallel.data_parallel import make_mesh

    rng = np.random.default_rng(3)
    models = _models(rng)
    with pytest.raises(ValueError, match="parity oracle"):
        ContinuousTrainer(
            models, ContinuousTrainConfig(fused=False), mesh=make_mesh()
        )
    with pytest.raises(ValueError, match="update"):
        ContinuousTrainer(models, ContinuousTrainConfig(update="bogus"))
