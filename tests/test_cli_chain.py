"""End-to-end CLI chain under pytest (VERDICT weak #5).

Drives the actual argparse scripts via subprocess — project3 train ->
project3 predict -> project5 train (silence) -> project6 embedded train ->
project5 n-digit eval with CSV — on the synthetic corpus with tiny configs,
then parses the CSV and asserts accuracy. Wiring regressions between argparse
and the library (the reference's project3->5->6 chain,
scripts/project3_train.py:17-35 ... project6_train.py:22-41) now fail CI.

Runs on CPU (subprocesses inherit the conftest's JAX_PLATFORMS=cpu env).
~4-6 minutes total; the chain shares one tmp checkpoint tree.
"""
import csv
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def run_script(name, *args, tmp):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["CS304_TRACEBACK"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, name), *args,
         "--log-file", os.path.join(tmp, "runtime.log")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=2400,
    )
    assert proc.returncode == 0, (
        f"{name} rc={proc.returncode}\nstdout:\n{proc.stdout[-3000:]}"
        f"\nstderr:\n{proc.stderr[-3000:]}"
    )
    return proc.stdout


@pytest.fixture(scope="module")
def tmp_chain_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cli_chain"))


def test_full_cli_chain(tmp_chain_dir):
    tmp = tmp_chain_dir
    ck3 = os.path.join(tmp, "ck3")
    ck5 = os.path.join(tmp, "ck5")
    ck6 = os.path.join(tmp, "ck6")
    state = os.path.join(tmp, "state")

    # project3: isolated-digit boot models.
    out = run_script(
        "project3_train.py", "--synthetic", "--checkpoint-dir", ck3,
        "--set", "train.max_iterations=6", "--set", "train.length_multiple=32",
        tmp=tmp,
    )
    assert "saved 11 models" in out
    assert os.path.exists(os.path.join(ck3, "1", "params.npz"))

    # project3 predict: isolated accuracy on the same corpus.
    out = run_script(
        "project3_predict.py", "--synthetic", "--checkpoint-dir", ck3, tmp=tmp,
    )
    assert "accuracy" in out.lower()

    # project5: endpointed digits + noise-trained silence model.
    out = run_script(
        "project5_train_no_empty.py", "--synthetic", "--checkpoint-dir", ck5,
        "--set", "train.max_iterations=6", "--set", "train.length_multiple=32",
        tmp=tmp,
    )
    assert "12 models" in out
    assert os.path.exists(os.path.join(ck5, "S", "params.npz"))

    # project6: embedded continuous training with a resumable .npz trainer state.
    run_script(
        "project6_train.py", "--synthetic", "--checkpoint-dir", ck5,
        "--out-dir", ck6, "--state-dir", state,
        "--set", "continuous.max_iterations=3",
        "--set", "continuous.cov_reg=0.1",
        tmp=tmp,
    )
    assert os.path.exists(os.path.join(ck6, "S", "params.npz"))

    # project5 eval: n-digit continuous decode, CSV out, parse + assert.
    csv_base = os.path.join(tmp, "results")
    out = run_script(
        "project5_test_ndigits.py", "--synthetic", "--checkpoint-dir", ck6,
        "--n-digits", "4", "--csv-out", csv_base, tmp=tmp,
    )
    assert "exact-sequence accuracy" in out

    for split in ("train", "test"):
        path = f"{csv_base}.{split}.csv"
        assert os.path.exists(path), f"missing {path}"
        with open(path) as fh:
            rows = list(csv.reader(fh, delimiter="|"))
        header, body = rows[0], rows[1:]
        assert body, f"{path} has no data rows"
        truth_i = header.index("Ground Truth")
        pred_i = header.index("Predict")
        acc = sum(r[truth_i] == r[pred_i] for r in body) / len(body)
        # Easy (legacy) corpus + tiny configs: the chain must still decode
        # essentially perfectly; anything lower means wiring broke.
        assert acc >= 0.9, f"{split} CSV accuracy {acc:.2%}"

    # Forced alignment against the trained checkpoint (scripts/align.py).
    from cs304_tpu.audio.wav import write_wav_int16
    from cs304_tpu.data.synthetic import SyntheticTIDigits

    corpus = SyntheticTIDigits(num_train_speakers=6, num_test_speakers=2,
                               takes_per_digit=3)
    wav_path = os.path.join(tmp, "align_me.wav")
    write_wav_int16(wav_path, corpus.sentence_audio("375", 0), 16000)
    align_csv = os.path.join(tmp, "alignments.csv")
    out = run_script(
        "align.py", "--checkpoint-dir", ck6, "--wav", wav_path,
        "--transcript", "375", "--csv-out", align_csv, "--states", tmp=tmp,
    )
    assert "transcript=375" in out
    with open(align_csv) as fh:
        rows = list(csv.reader(fh, delimiter="|"))
    header, body = rows[0], rows[1:]
    assert [r[header.index("word")] for r in body] == ["3", "7", "5"]
    # Frame ranges are increasing and non-trivial.
    sf, ef = header.index("start_frame"), header.index("end_frame")
    for r in body:
        assert int(r[ef]) > int(r[sf])
