"""The port's model registry resolves the reference's generator paths, and
its ``Trainer`` reads ``cfg['restore']`` at run start, as the JAX package's
do (``cloud_transformers_tpu/models/__init__.py``,
``cloud_transformers_tpu/train/trainer.py``).  CPU only, no JAX.
"""

import logging

import pytest
import torch

from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.train.checkpoint import save_params_only
from cloud_transformers_tpu_torch.train.config import model_from_config
from cloud_transformers_tpu_torch.train.trainer import Trainer

TINY_CLASSIFIER = dict(model_dim=32, repeats=1,
                       stage_plan=[[[4, 4], [2, 2], [16, 16], [2, 3]]],
                       pool_heads=2, pool_feature_dims=[4, 4],
                       pool_sizes=[4, 8], trunk_width=8, class_dim=32,
                       mask_dim=16)
TINY_INPAINTER = dict(num_latent=16, model_dim=32, latent_width=24,
                      encoder_repeats=1, decoder_repeats=1,
                      stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),),
                      pool_heads=2, pool_feature_dims=(4, 4),
                      pool_sizes=(4, 8), trunk_width=8)


@pytest.mark.parametrize("path,kwargs,cls", [
    ("./model_zoo/scanobject/classifier.py", TINY_CLASSIFIER, "Classifier"),
    ("./model_zoo_tpu/scanobject/classifier.py", TINY_CLASSIFIER,
     "Classifier"),
    ("./model_zoo/completion/inpainter.py", TINY_INPAINTER, "Inpainter"),
])
def test_reference_generator_paths_resolve(path, kwargs, cls):
    assert type(get_model(path, **kwargs)).__name__ == cls


def test_config_in_the_reference_schema_builds_its_model():
    model = model_from_config({"model": dict(
        TINY_CLASSIFIER, generator="./model_zoo/scanobject/classifier.py")})
    assert type(model).__name__ == "Classifier"
    with pytest.raises(KeyError):
        get_model("./model_zoo/scanobject/nope.py")


def _cfg(tmp_path, **extra):
    return {"experiment": {"root": str(tmp_path / "exp")},
            "train": {"optimizer": {"type": "Adam", "lr": 1e-3},
                      "save": True},
            **extra}


def _loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean(), {}


def _trainer(cfg, seed=0, name="run"):
    return Trainer(torch.nn.Linear(3, 2), cfg, name, _loss, device="cpu",
                   seed=seed)


def test_restore_loads_the_weights_and_the_new_lr(tmp_path, caplog):
    source = torch.nn.Linear(3, 2)
    with torch.no_grad():
        source.weight.copy_(torch.arange(6.0).reshape(2, 3))
        source.bias.fill_(-1.0)
    path = tmp_path / "pretrained.pt"
    save_params_only(source, str(path))
    cfg = _cfg(tmp_path, restore={"generator": str(path), "new_lr": 0.25})
    cfg["train"]["best_metric"] = "cls_acc"
    with caplog.at_level(logging.INFO, "cloud_transformers_tpu_torch"):
        trainer = _trainer(cfg)
    assert torch.equal(trainer.model.weight, source.weight)
    assert torch.equal(trainer.model.bias, source.bias)
    assert trainer.optimizer.lrs == [0.25]
    # the new optimizer updates the restored parameters
    batch = {"x": torch.ones(4, 3).numpy(), "y": torch.zeros(4, 2).numpy()}
    trainer.train_step(batch)
    assert not torch.equal(trainer.model.bias, source.bias)
    assert "restored params from" in caplog.text
    # the best-metric keys are ported (tests/test_torch_trainer_best.py)
    assert "not ported" not in caplog.text


def test_restore_without_new_lr_keeps_the_configs_lr(tmp_path):
    source = torch.nn.Linear(3, 2)
    path = tmp_path / "pretrained.pt"
    save_params_only(source, str(path))
    trainer = _trainer(_cfg(tmp_path, restore={"generator": str(path)}),
                       seed=5)
    assert torch.equal(trainer.model.weight, source.weight)
    assert trainer.optimizer.lrs == [1e-3]


def test_auto_resume_skips_restore(tmp_path, caplog):
    first = _trainer(_cfg(tmp_path), seed=1)
    batch = {"x": torch.ones(4, 3).numpy(), "y": torch.zeros(4, 2).numpy()}
    first.train_step(batch)
    first.save()
    pretrained = torch.nn.Linear(3, 2)
    path = tmp_path / "pretrained.pt"
    save_params_only(pretrained, str(path))
    cfg = _cfg(tmp_path, restore={"generator": str(path), "new_lr": 0.5})
    with caplog.at_level(logging.INFO, "cloud_transformers_tpu_torch"):
        resumed = _trainer(cfg, seed=2)
    assert resumed.global_step == 1
    assert torch.equal(resumed.model.weight, first.model.weight)
    assert resumed.optimizer.lrs == [1e-3]
    assert "skipping cfg['restore']" in caplog.text
