"""Cross-option integration coverage: decode backends agree end-to-end; the
reference-parity cross_word='band' training mode still runs; fast-mode MFCC
config is accepted end to end."""
import numpy as np
import pytest

from cs304_tpu.models.decoder import ContinuousDecoder
from cs304_tpu.models.hmm import WordHMM, uniform_forward_log_a
from cs304_tpu.models.train_continuous import (
    ContinuousTrainConfig,
    ContinuousTrainer,
)
from cs304_tpu.ops.mfcc import MFCCConfig, mfcc_features

import jax.numpy as jnp


def mk(label, s, seed):
    r = np.random.default_rng(seed)
    return WordHMM(
        label=label,
        means=r.normal(size=(s, 5)).astype(np.float32) * 2,
        covariances=np.tile(np.eye(5, dtype=np.float32), (s, 1, 1)),
        log_a=uniform_forward_log_a(s),
    )


@pytest.fixture
def models():
    return {"A": mk("A", 5, 1), "B": mk("B", 4, 2), "S": mk("S", 3, 3)}


def test_backends_agree_on_predictions(models, rng, interpret_kernel):
    feats = [
        (rng.normal(size=(t, 5)) * 2).astype(np.float32) for t in (30, 55, 18)
    ]
    outs = {}
    for backend in ("scan", "fast", "scanfree"):
        dec = ContinuousDecoder(dict(models), penalty=-8.0, backend=backend)
        outs[backend] = dec.predict_batch(feats)
    assert outs["scan"] == outs["fast"] == outs["scanfree"]


def test_band_parity_training_mode(models, rng):
    labeled = {
        "AB": [(rng.normal(size=(40, 5)) * 2).astype(np.float32) for _ in range(4)]
    }
    trainer = ContinuousTrainer(
        dict(models),
        ContinuousTrainConfig(
            max_iterations=2, length_multiple=8, silence_bootstrap=False,
            cross_word="band",
        ),
    )
    trainer.train(labeled)
    out = trainer.models()
    for m in out.values():
        assert np.isfinite(m.means).all()


def test_fast_mode_mfcc_config(rng):
    sig = (rng.normal(size=4000) * 2000).astype(np.float32)
    parity, t1 = mfcc_features(jnp.asarray(sig), cfg=MFCCConfig())
    fast, t2 = mfcc_features(jnp.asarray(sig), cfg=MFCCConfig(precision="high"))
    assert int(t1) == int(t2)
    # On CPU precision settings are no-ops, so results match exactly; on the
    # GPU "high" is a 3-pass bf16 DFT (see MFCCConfig.precision).
    np.testing.assert_allclose(
        np.asarray(parity)[: int(t1)], np.asarray(fast)[: int(t2)],
        rtol=1e-3, atol=1e-3,
    )


def test_emission_precision_tiers(models, rng):
    """Each tier names its arithmetic: HIGHEST is true f32, "high" the 3-pass
    bf16 algorithm (not Precision.HIGH, which is TF32 on the GPU), "default"
    the backend's default dot. Below HIGHEST needs the quad layout."""
    import jax
    import pytest

    from cs304_tpu.models.decoder import EMISSION_PRECISION

    assert EMISSION_PRECISION == {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
        "default": jax.lax.Precision.DEFAULT,
    }
    feats = [(rng.normal(size=(t, 5)) * 2).astype(np.float32)
             for t in (30, 18)]
    outs = {tier: ContinuousDecoder(dict(models), penalty=-8.0,
                                    emissions="quad",
                                    emission_precision=tier
                                    ).predict_batch(feats)
            for tier in EMISSION_PRECISION}
    assert outs["high"] == outs["highest"] == outs["default"]
    with pytest.raises(ValueError, match="require"):
        ContinuousDecoder(dict(models), emission_precision="high")
    with pytest.raises(ValueError, match="unknown emission precision"):
        ContinuousDecoder(dict(models), emissions="quad",
                          emission_precision="tf32")
