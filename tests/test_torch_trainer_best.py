"""The port's ``Trainer.fit`` keeps the best-metric checkpoints of the JAX
trainer (``cloud_transformers_tpu/train/trainer.py``): ``ckpt_best`` for
``train.best_metric`` (default ``loss``) and ``ckpt_<key>_best`` for each of
``train.best_metrics``, saved where a validation raises the key's score.
The classification CLI sets ``cls_acc`` and ``m_acc`` as the JAX CLI does,
and the completion CLI leaves the ``ckpt_best`` that its eval config
restores.  CPU only, no JAX.
"""

import logging
import os

import numpy as np
import pytest
import torch
import yaml

from cloud_transformers_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS_PER_EPOCH = 2


class _Loader:
    """Two fixed batches an epoch."""

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        for _ in range(STEPS_PER_EPOCH):
            yield {"x": np.ones((4, 3), np.float32),
                   "y": np.zeros((4, 2), np.float32)}


def _loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean(), {}


def _fit(tmp_path, val, epochs=3, name="run", **train):
    """Fit a linear model for ``epochs`` epochs with validation after each;
    the validation after epoch e reports ``val[key][e]`` for each key.
    -> the trainer."""
    cfg = {"experiment": {"root": str(tmp_path / "exp")},
           "train": {"optimizer": {"type": "Adam", "lr": 1e-2},
                     "num_epochs": epochs, "show_each": 100, **train}}
    holder = {}

    def eval_fn(model, batch):
        done = holder["trainer"].epoch - 1
        return (torch.tensor(val["loss"][done]),
                {k: torch.tensor(v[done]) for k, v in val.items()
                 if k != "loss"})
    trainer = Trainer(torch.nn.Linear(3, 2), cfg, name, _loss,
                      eval_fn=eval_fn, device="cpu", seed=0)
    holder["trainer"] = trainer
    trainer.fit(_Loader(), _Loader())
    return trainer


def _checkpoints(path):
    """The checkpoint files in an experiment directory (which also holds
    the run's logs and its config copy)."""
    return sorted(f for f in os.listdir(path) if f.startswith("ckpt_"))


def _saved_step(trainer, tag):
    return trainer.ckpt.restore(tag)["meta"]["global_step"]


def test_best_follows_the_lowest_validation_loss(tmp_path):
    trainer = _fit(tmp_path, {"loss": [3.0, 1.0, 2.0]})
    assert _saved_step(trainer, "best") == 2 * STEPS_PER_EPOCH
    payload = trainer.ckpt.restore("best")
    assert payload["meta"]["epoch"] == 2
    latest = trainer.ckpt.restore("latest")
    assert latest["meta"]["global_step"] == 3 * STEPS_PER_EPOCH
    assert not torch.equal(payload["model"]["weight"],
                           latest["model"]["weight"])
    assert _checkpoints(trainer.exp_dir) == ["ckpt_best.pt",
                                                   "ckpt_latest.pt"]


def test_classification_keys_write_best_and_macc_best(tmp_path):
    trainer = _fit(tmp_path, {"loss": [3.0, 2.0, 1.0],
                              "cls_acc": [0.2, 0.5, 0.4],
                              "m_acc": [0.1, 0.05, 0.3]},
                   best_metric="cls_acc", best_metrics=["m_acc", "cls_acc"])
    assert _saved_step(trainer, "best") == 2 * STEPS_PER_EPOCH
    assert _saved_step(trainer, "macc_best") == 3 * STEPS_PER_EPOCH
    # the loss is no key once best_metric names another
    assert _checkpoints(trainer.exp_dir) == [
        "ckpt_best.pt", "ckpt_latest.pt", "ckpt_macc_best.pt"]


def test_a_missing_key_never_saves(tmp_path):
    trainer = _fit(tmp_path, {"loss": [3.0, 2.0, 1.0]},
                   best_metrics=["miou"])
    assert _saved_step(trainer, "best") == 3 * STEPS_PER_EPOCH
    assert not trainer.ckpt.exists("miou_best")


def test_save_false_writes_no_checkpoint(tmp_path):
    trainer = _fit(tmp_path, {"loss": [3.0, 1.0, 2.0], "m_acc": [1, 2, 3]},
                   best_metrics=["m_acc"], save=False)
    assert _checkpoints(trainer.exp_dir) == []


def test_bests_start_afresh_when_a_run_resumes(tmp_path):
    """A resumed ``fit`` saves ``best`` at its first validation, however
    the earlier run scored: the bests are not part of a checkpoint."""
    first = _fit(tmp_path, {"loss": [1.0, 2.0, 3.0, 9.0]}, epochs=2)
    assert _saved_step(first, "best") == STEPS_PER_EPOCH
    resumed = _fit(tmp_path, {"loss": [1.0, 2.0, 3.0, 9.0]}, epochs=4)
    assert resumed.global_step == 4 * STEPS_PER_EPOCH
    assert _saved_step(resumed, "best") == 3 * STEPS_PER_EPOCH


def test_best_metric_keys_no_longer_warn(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, "cloud_transformers_tpu_torch"):
        _fit(tmp_path, {"loss": [1.0], "cls_acc": [0.5], "m_acc": [0.5]},
             epochs=1, best_metric="cls_acc", best_metrics=["m_acc"])
    assert "not ported" not in caplog.text


def _tiny_cli_config(tmp_path, name, **edits):
    from cloud_transformers_tpu_torch.train.config import load_config
    cfg = load_config(os.path.join(ROOT, "configs", name))
    cfg["experiment"] = {"root": str(tmp_path / "exp"),
                         "writer_root": str(tmp_path / "runs")}
    for section, values in edits.items():
        cfg.setdefault(section, {}).update(values)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_classification_cli_leaves_best_and_macc_best(tmp_path):
    from cloud_transformers_tpu_torch import train_classification
    path = _tiny_cli_config(
        tmp_path, "scanobjectnn.yaml",
        data=dict(batch_size=64, batch_size_val=128, num_points=32),
        model=dict(model_dim=32, repeats=1,
                   stage_plan=[[[4, 4], [2, 2], [16, 16], [2, 3]]],
                   pool_heads=2, pool_feature_dims=[4, 4],
                   pool_sizes=[4, 8], trunk_width=8, class_dim=32,
                   mask_dim=16),
        train=dict(num_epochs=1, show_each=100, save_each_epoch=1))
    train_classification.main(["x", "-c", path, "--synthetic", "--device",
                               "cpu"])
    exp = tmp_path / "exp" / "x"
    assert _checkpoints(exp) == ["ckpt_best.pt", "ckpt_latest.pt",
                                       "ckpt_macc_best.pt"]


def test_inpainter_cli_leaves_the_best_its_eval_config_restores(tmp_path):
    from cloud_transformers_tpu_torch import train_inpainter
    from cloud_transformers_tpu_torch.train.config import load_config
    eval_cfg = load_config(os.path.join(ROOT, "configs", "eval",
                                        "inpainting.yaml"))
    assert os.path.basename(
        eval_cfg["restore"]["generator"]).startswith("ckpt_best")
    path = _tiny_cli_config(
        tmp_path, "inpainting.yaml",
        data=dict(batch_size=16, batch_size_val=32, n_renders=1,
                  input_size=32, gt_size=64),
        model=dict(num_latent=16, model_dim=32, latent_width=24,
                   encoder_repeats=1, decoder_repeats=1,
                   stage_plan=[[[4, 4], [2, 2], [16, 16], [2, 3]]],
                   pool_heads=2, pool_feature_dims=[4, 4],
                   pool_sizes=[4, 8], trunk_width=8),
        train=dict(num_epochs=1, show_each=100, val_emd_iters=5))
    train_inpainter.main(["x", "-c", path, "--synthetic", "--device", "cpu"])
    assert _checkpoints(tmp_path / "exp" / "x") == [
        "ckpt_best.pt", "ckpt_latest.pt"]


@pytest.mark.parametrize("key,tag", [("loss", "best"), ("m_acc", "macc_best"),
                                     ("miou", "miou_best")])
def test_tags_follow_the_jax_names(tmp_path, key, tag):
    """A key other than the first is saved as ``<key>_best``, with
    ``m_acc`` written ``macc``."""
    val = {"loss": [2.0, 1.0], key: [0.0, 1.0]} if key != "loss" else {
        "loss": [2.0, 1.0]}
    trainer = _fit(tmp_path, val, epochs=2, best_metric="loss",
                   best_metrics=[key])
    assert _saved_step(trainer, tag) == 2 * STEPS_PER_EPOCH
