"""Port parity: the completion path's data, noise, task and checkpoints.

* ``partial_postprocess``: its deterministic half value for value against
  the JAX function, fed the noise and the resampling draws that JAX made
  from its key; the drawing half by its properties.
* ``sphere_noise`` lies on the unit sphere and covers it.
* ``ShapeNetCompletion`` items, ``random_sample_points``, ``random_mirror``
  and ``read_pcd`` equal the JAX package's, value for value.
* ``make_loss_fn`` runs on a tiny model; a checkpoint carries model,
  optimizer, schedule, step and generators, and a new ``Trainer`` in the
  same directory resumes to the same next step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.core import noise as jnoise
from cloud_transformers_tpu.data import completion as jdata
from cloud_transformers_tpu.data import pointcloud_io as jio
from cloud_transformers_tpu_torch.core import noise as tnoise
from cloud_transformers_tpu_torch.data import completion as tdata
from cloud_transformers_tpu_torch.data import pointcloud_io as tio
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.tasks import completion as ttask
from cloud_transformers_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_params_only,
    save_params_only,
)
from cloud_transformers_tpu_torch.train.trainer import Trainer

TINY = dict(num_latent=16, model_dim=32, latent_width=24, encoder_repeats=1,
            decoder_repeats=1,
            stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),),
            pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
            trunk_width=8)


def _partial(seed=0, b=3, p=64):
    rs = np.random.RandomState(seed)
    partial = rs.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    partial[0, 40:] = 0.0                  # zero-padded tails
    partial[1, 10:] = 0.0
    return partial


def test_partial_postprocess_deterministic_half_matches_jax():
    partial, gt_size = _partial(), 160
    key = jax.random.PRNGKey(7)
    want_parts, want_noise = jnoise.partial_postprocess(
        key, jnp.asarray(partial), gt_size)
    # the draws JAX makes from this key, as partial_postprocess makes them
    k_noise, k_resample = jax.random.split(key)
    noise = jnoise.sphere_noise(k_noise, 3, gt_size)
    valid = ~np.all(partial == 0.0, -1)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    draw = jax.random.categorical(k_resample, logits[:, None, :], axis=-1,
                                  shape=(3, 64))
    parts, labeled = tnoise.partial_postprocess_from_draws(
        torch.from_numpy(partial), torch.from_numpy(np.array(noise)),
        torch.from_numpy(np.array(draw)).long())
    np.testing.assert_array_equal(parts.numpy(), np.asarray(want_parts))
    np.testing.assert_array_equal(labeled.numpy(), np.asarray(want_noise))


def test_partial_postprocess_draws():
    partial, gt_size = _partial(1), 200
    t = torch.from_numpy(partial)
    gen = torch.Generator().manual_seed(0)
    parts, labeled = tnoise.partial_postprocess(gen, t, gt_size)
    valid = ~np.all(partial == 0.0, -1)
    assert parts.shape == (3, 64, 3) and labeled.shape == (3, gt_size, 4)
    # valid rows keep their point, invalid rows hold some valid point
    np.testing.assert_array_equal(parts.numpy()[valid], partial[valid])
    for b in range(3):
        pool = {tuple(r) for r in partial[b][valid[b]]}
        assert all(tuple(r) in pool for r in parts.numpy()[b])
    label = labeled[..., 3].numpy()
    np.testing.assert_array_equal(label[:, :64], valid.astype(np.float32))
    assert not label[:, 64:].any()
    xyz = labeled[..., :3].numpy()
    np.testing.assert_array_equal(xyz[:, :64][valid], partial[valid])
    np.testing.assert_allclose(np.linalg.norm(xyz[label == 0], axis=-1), 1.0,
                               atol=1e-5)
    # the same generator state gives the same draws
    again = tnoise.partial_postprocess(torch.Generator().manual_seed(0), t,
                                       gt_size)
    assert torch.equal(again[0], parts) and torch.equal(again[1], labeled)
    other = tnoise.partial_postprocess(gen, t, gt_size)
    assert not torch.equal(other[1], labeled)


def test_sphere_noise_is_uniform_on_the_sphere():
    pts = tnoise.sphere_noise(torch.Generator().manual_seed(0), 4, 4096)
    assert pts.shape == (4, 4096, 3) and pts.dtype == torch.float32
    np.testing.assert_allclose(pts.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    # uniform on the sphere: each coordinate is uniform on [-1, 1]
    flat = pts.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.02)
    np.testing.assert_allclose(flat.var(0), 1 / 3, atol=0.02)
    # the same map from uniforms as JAX's
    u = np.random.RandomState(0).rand(2, 5, 7).astype(np.float32)
    got = tnoise.sphere_from_uniforms(torch.from_numpy(u[0]),
                                      torch.from_numpy(u[1])).numpy()
    theta, cos_phi = 2 * np.pi * u[0], 1 - 2 * u[1]
    sin_phi = np.sqrt(np.clip(1 - cos_phi * cos_phi, 0, None))
    np.testing.assert_allclose(
        got, np.stack([sin_phi * np.cos(theta), sin_phi * np.sin(theta),
                       cos_phi], -1), atol=1e-6)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_items_match_jax(split):
    kw = dict(split=split, n_renders=2, n_input=128, n_output=512,
              synthetic_items=3)
    want_ds, got_ds = jdata.ShapeNetCompletion(**kw), \
        tdata.ShapeNetCompletion(**kw)
    assert len(got_ds) == len(want_ds) == (6 if split == "train" else 3)
    for epoch in (0, 2):
        want_ds.set_epoch(epoch)
        got_ds.set_epoch(epoch)
        for i in (0, len(got_ds) - 1):
            want, got = want_ds[i], got_ds[i]
            assert set(got) == {"partial", "gt", "taxonomy"}
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["partial"].dtype == got["gt"].dtype == np.float32


def test_sampling_and_mirror_match_jax():
    rs = np.random.RandomState(0)
    pcd = rs.randn(50, 3).astype(np.float32)
    for n in (20, 80):
        np.testing.assert_array_equal(
            tdata.random_sample_points(pcd, n, np.random.RandomState(3)),
            jdata.random_sample_points(pcd, n, np.random.RandomState(3)))
    assert not tdata.random_sample_points(
        pcd, 80, np.random.RandomState(3))[50:].any()
    for rv in (0.1, 0.3, 0.6, 0.9):
        np.testing.assert_array_equal(tdata.random_mirror(pcd, rv),
                                      jdata.random_mirror(pcd, rv))


@pytest.mark.parametrize("mode", ["ascii", "binary"])
def test_read_pcd_matches_jax(tmp_path, mode):
    xyz = np.random.RandomState(0).randn(37, 3).astype(np.float32)
    path = str(tmp_path / f"cloud_{mode}.pcd")
    if mode == "ascii":
        jio.write_pcd(path, xyz)
    else:
        with open(path, "wb") as f:
            f.write(b"# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\n"
                    b"TYPE F F F\nCOUNT 1 1 1\nWIDTH 37\nHEIGHT 1\n"
                    b"POINTS 37\nDATA binary\n" + xyz.tobytes())
    got = tio.read_pcd(path)
    np.testing.assert_array_equal(got, jio.read_pcd(path))
    np.testing.assert_allclose(got, xyz, atol=1e-6)
    with open(path, "wb") as f:
        f.write(b"FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nPOINTS 1\n"
                b"DATA binary_compressed\n")
    with pytest.raises(ValueError):
        tio.read_pcd(path)


def _cfg(tmp_path, **train):
    return {"experiment": {"root": str(tmp_path / "exp")},
            "data": {"batch_size": 2, "n_renders": 1, "input_size": 64,
                     "gt_size": 128},
            "train": {"optimizer": {"type": "Adam", "lr": 1e-3},
                      "scheduler": {"type": "StepLR", "gamma": 0.5,
                                    "step_size": 2},
                      "scale_lr": 1e-2, "show_each": 2, **train}}


def _trainer(cfg, seed=0):
    gens = {"train": torch.Generator().manual_seed(seed + 1)}
    return Trainer(get_model("completion_inpainter", **TINY), cfg, "run",
                   ttask.make_loss_fn(gens["train"], chamfer_weight=0.5),
                   device="cpu", seed=seed, generators=gens)


def test_make_loss_fn_and_datasets_run(tmp_path):
    cfg = _cfg(tmp_path)
    train_loader, val_loader = ttask.make_datasets(cfg, synthetic=True)
    batch = next(iter(train_loader))
    assert batch["partial"].shape == (2, 64, 3)
    assert batch["gt"].shape == (2, 128, 3)
    assert len(val_loader.dataset) == 32 and not val_loader.shuffle
    trainer = _trainer(cfg)
    m = trainer.train_step(batch)
    assert {"loss", "loss_emd", "loss_chamfer", "occupancy_mean"} <= set(m)
    assert torch.isfinite(m["loss"]) and m["loss"] > m["loss_emd"]
    for n, p in trainer.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    # validation's high-accuracy EMD runs through the same loss function
    eval_fn = ttask.make_loss_fn(torch.Generator().manual_seed(2),
                                 emd_eps=0.004, emd_iters=100)
    trainer.eval_fn = eval_fn
    val = trainer.eval_step(next(iter(val_loader)))
    assert torch.isfinite(val["loss"]) and "loss_chamfer" not in val


def test_checkpoint_round_trip_and_auto_resume(tmp_path):
    cfg = _cfg(tmp_path, save_each=2)
    train_loader, _ = ttask.make_datasets(cfg, synthetic=True)
    trainer = _trainer(cfg)
    assert not trainer.ckpt.exists("latest")
    trainer.fit(train_loader, max_steps=3)
    assert trainer.ckpt.exists("latest")            # saved at max_steps
    payload = CheckpointManager(trainer.exp_dir).restore("latest")
    assert payload["meta"] == {"global_step": 3, "epoch": 0}
    assert set(payload["generators"]) == {"trainer", "torch", "task.train"}
    batch = next(iter(train_loader))
    want = trainer.train_step(batch)                # the 4th step

    # a new trainer in the same directory resumes: model, Adam moments,
    # schedule, step and the noise generator's state
    resumed = _trainer(cfg, seed=9)                 # another seed: unused
    assert (resumed.global_step, resumed.epoch) == (3, 0)
    assert resumed.optimizer.lrs == [0.5e-3, 0.5e-2]
    got = resumed.train_step(batch)
    assert float(got["loss"]) == float(want["loss"])
    for (n, a), (_, b) in zip(trainer.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n

    # auto_resume off: a fresh run
    cfg["train"]["auto_resume"] = False
    assert _trainer(cfg).global_step == 0

    # params only: from a trainer checkpoint and from a bare file
    path = trainer.save("5")
    assert path.endswith("ckpt_5.pt")
    fresh = restore_params_only(path, get_model("completion_inpainter",
                                                **TINY))
    bare = str(tmp_path / "export" / "model.pt")
    save_params_only(fresh, bare)
    again = restore_params_only(bare, get_model("completion_inpainter",
                                                **TINY))
    for (n, a), (_, b), (_, c) in zip(trainer.model.state_dict().items(),
                                      fresh.state_dict().items(),
                                      again.state_dict().items()):
        assert torch.equal(a, b) and torch.equal(a, c), n
    torch.save({"meta": {"global_step": 1}}, bare)
    with pytest.raises(ValueError):
        restore_params_only(bare, fresh)


def test_epoch_end_saves_the_next_epoch(tmp_path):
    cfg = _cfg(tmp_path)
    cfg["data"]["batch_size"] = 16
    train_loader, _ = ttask.make_datasets(cfg, synthetic=True)
    trainer = _trainer(cfg)
    trainer.fit(train_loader, num_epochs=1)
    assert trainer.global_step == len(train_loader) == 2
    meta = trainer.ckpt.restore("latest")["meta"]
    assert meta == {"global_step": 2, "epoch": 1}
    cfg["train"]["save"] = False
    trainer.fit(train_loader, num_epochs=2)
    assert trainer.ckpt.restore("latest")["meta"]["global_step"] == 2
