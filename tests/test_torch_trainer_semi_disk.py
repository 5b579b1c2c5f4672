"""The port's mean-teacher trainer, ``train_lib.run_semi``, against the JAX
package's on a seeded DCASE layout on disk: 4 strong, 4 weak and 8
unlabeled clips of ``unlabel_in_domain.tsv`` at 496 x 64 (2 steps an
epoch), 4 validation and 4 eval clips, each side extracting its own ``.npy``
cache and computing its own scaler; the harness, sizes, tolerances and
teacher checkpoint of ``tests/test_torch_trainer_semi.py`` (a file of its
own, so that xdist runs the two side by side).
"""
import shutil

import pytest
import torch

from sound_event_detection_transformer_tpu_torch.data import wav_dataset
from test_torch_trainer_semi import TINY, assert_runs_match, run_both

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("disk")
    src = tmp / "written"
    wav_dataset.write_dcase(str(src), strong=4, weak=4, unlabel=8, validate=4, test=4, seed=3)
    roots = {side: tmp / f"data_{side}" for side in ("jax", "torch")}
    for root in roots.values():
        shutil.copytree(src, root)
    return run_both(TINY, tmp, jax_extra=["--data_root", str(roots["jax"])],
                    torch_extra=["--data_root", str(roots["torch"])])


def test_dcase_on_disk_matches_jax(disk):
    want, result = disk
    assert_runs_match(want, result, steps=2)  # 4 weak clips at 2 a batch
    t = result.data_timings
    assert t["extracted"] == t["clips"] == 4 + 4 + 8 + 4 + 4 and t["scaler_s"] >= 0
