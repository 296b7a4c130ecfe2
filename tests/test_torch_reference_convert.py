"""The reference implementation's own state dicts (its released ``.t7``
files) in the port: ``convert.reference_state_dict`` for the classifier
(with and without per-head scales), the completion inpainter and the
single-view reconstructor, against the JAX package's
``tools/convert_torch_checkpoint.py`` followed by ``jax_to_state_dict``,
tensor for tensor at full width; the reduced-width scales classifier's
logits from a ``.t7`` against the JAX model loaded through the JAX tool (by
PARITY.md: cosine > 0.999, median error <= 1e-3 of max(1, max |logit|));
``InferenceEngine.from_checkpoint`` from a ``.t7``, from a port checkpoint
and from a seed; both evaluation command lines from a ``.t7``.

The state dicts are built here: the classifier's and the inpainter's by
``tests/test_checkpoint_convert.py``'s ``synth_reference_*_sd``, the
reconstructor's from the names torchvision's ResNet-50 gives the keys the
JAX tool reads.  ``chip_smoke.reference_layout`` (the port's names back to
the reference's, which the card's run uses to make its ``.t7``) is held to
the same names and shapes and to the converter's inverse."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu_torch import convert
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.models import reconstructor as trec_mod
from cloud_transformers_tpu_torch.models.inpainter import AdaInDecoder
from cloud_transformers_tpu_torch.nn.init import init_model_
from cloud_transformers_tpu_torch.serve import InferenceEngine
from cloud_transformers_tpu_torch.train.checkpoint import save_params_only
from tests.test_checkpoint_convert import (
    synth_reference_classifier_sd,
    synth_reference_inpainter_sd,
)
from tools.convert_torch_checkpoint import convert as jax_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = ("scanobject_classifier", "scanobject_classifier_scales",
        "completion_inpainter", "image_reconstructor")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's workers share the CPU's cores
    (``tests/test_torch_chip_smoke.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _with_scales(sd, rs):
    """Add the frames' ``transform.scales`` [H, dims] of
    ``classifier_scales.py`` (dims from the head's grid: its conv kernel's
    rank, or the pool's name)."""
    out = dict(sd)
    for k, v in sd.items():
        if not k.endswith("transform.log_R"):
            continue
        head = k[:-len(".transform.log_R")]
        conv = sd.get(f"{head}.conv.0.weight")
        dims = conv.ndim - 2 if conv is not None else (
            2 if head.endswith("pool2d") else 3)
        out[f"{head}.transform.scales"] = rs.uniform(
            0.5, 1.5, (v.shape[0], dims)).astype(np.float32)
    return out


def _resnet50_sd(rs, prefix="res50_model.0.features"):
    """The names and shapes of torchvision's ResNet-50 children()[:-2]
    (0 conv1, 1 bn1, 4-7 layer1-4), the keys the JAX tool reads."""
    sd = {}

    def bn(p, c):
        sd[f"{p}.weight"] = rs.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{p}.bias"] = rs.randn(c).astype(np.float32)
        sd[f"{p}.running_mean"] = rs.randn(c).astype(np.float32)
        sd[f"{p}.running_var"] = rs.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{p}.num_batches_tracked"] = np.int64(7)

    sd[f"{prefix}.0.weight"] = rs.randn(64, 3, 7, 7).astype(np.float32)
    bn(f"{prefix}.1", 64)
    cin = 64
    for stage, (n, planes) in enumerate(zip((3, 4, 6, 3),
                                            (64, 128, 256, 512))):
        for b in range(n):
            blk = f"{prefix}.{4 + stage}.{b}"
            for c, (o, i, k) in enumerate(((planes, cin, 1),
                                           (planes, planes, 3),
                                           (4 * planes, planes, 1))):
                sd[f"{blk}.conv{c + 1}.weight"] = rs.randn(
                    o, i, k, k).astype(np.float32)
                bn(f"{blk}.bn{c + 1}", o)
            if b == 0:
                sd[f"{blk}.downsample.0.weight"] = rs.randn(
                    4 * planes, cin, 1, 1).astype(np.float32)
                bn(f"{blk}.downsample.1", 4 * planes)
            cin = 4 * planes
    return sd


def _reconstructor_sd(rs):
    """model_zoo/image_reconstruction/reconstructor.py: the ResNet-50 and
    the inpainter's AdaIN decoder with a 2048 -> 512 mapping, a 3-channel
    start and a final head that does not see the noise again."""
    sd = _resnet50_sd(rs)
    inp = synth_reference_inpainter_sd(rs)
    sd.update({k: v for k, v in inp.items()
               if k.startswith(("attentions_decoder.", "start.1.",
                                "final.1.", "final.3."))})
    sd["mapping.0.weight"] = rs.randn(512, 2048).astype(np.float32)
    sd["mapping.0.bias"] = rs.randn(512).astype(np.float32)
    sd["start.0.weight"] = rs.randn(512, 3, 1).astype(np.float32)
    sd["final.0.weight"] = rs.randn(512, 512, 1).astype(np.float32)
    return sd


def _reference_sd(name, rs):
    if name == "completion_inpainter":
        return synth_reference_inpainter_sd(rs)
    if name == "image_reconstructor":
        return _reconstructor_sd(rs)
    sd = synth_reference_classifier_sd(rs)
    return _with_scales(sd, rs) if name.endswith("_scales") else sd


@pytest.mark.parametrize("name", FULL)
def test_reference_converter_matches_the_jax_tool(name):
    """Full width: the same tensors by either route, loaded strictly; and
    ``chip_smoke.reference_layout`` gives back the reference's names and
    shapes, which convert to the same tensors again."""
    sd = _reference_sd(name, np.random.RandomState(0))
    params, stats = jax_tool(name, sd)
    want = convert.jax_to_state_dict({"params": params,
                                      "batch_stats": stats})
    got = convert.reference_state_dict(
        name, {f"module.{k}": v for k, v in sd.items()})
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    model = get_model(name)
    model.load_state_dict(got, strict=True)
    if name == "scanobject_classifier_scales":
        assert sum(k.endswith("transform.scales") for k in got) == 26
    back = chip_smoke.reference_layout(name, got)
    ref = {k: v for k, v in sd.items()
           if not k.endswith("num_batches_tracked")}
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_reference_converter_refuses_unknown_models_and_names():
    sd = synth_reference_classifier_sd(np.random.RandomState(0))
    with pytest.raises(NotImplementedError, match="scanobject_classifier"):
        convert.reference_state_dict("no_such_model", sd)
    with pytest.raises(KeyError, match="no counterpart"):
        convert.reference_state_dict(
            "scanobject_classifier", dict(sd, **{"extra.0.weight": 0.0}))


def _scaled(sd, rs):
    """Values of a trained-like scale, so that 12 random blocks stay O(1):
    kernels by 1 / sqrt(fan in), BatchNorm scales about 1, biases and
    running means about 0, running variances about 1
    (``tests/test_torch_segmentation_kpconv_task.py``).  The key
    BatchNorms' scales are 0.05-0.15, small key offsets as early in
    training: at 0.2-0.6 this random 12-block classifier is chaotic, and
    its logits move by a median 4.6e-3 of their scale when the cloud is
    jittered by 1e-6 in the port alone (a grid cell's winner flips and the
    blocks amplify it), so a comparison there measures that chaos; at
    0.05-0.15 the port's own jitter floor is 3.4e-4."""
    bns = {k[:-len(".running_var")] for k in sd if k.endswith("running_var")}
    out = {}
    for k, v in sd.items():
        layer, leaf = k.rsplit(".", 1)
        if layer in bns:
            lo, hi = ((0.05, 0.15) if layer.endswith("key_bn")
                      else (0.5, 1.5))
            v = (rs.uniform(lo, hi, v.shape) if leaf in ("weight",
                                                         "running_var")
                 else 0.1 * rs.randn(*v.shape))
        elif leaf == "weight" and v.ndim >= 2:
            v = v / np.sqrt(np.prod(v.shape[1:]))
        elif leaf == "bias":
            v = 0.1 * v
        out[k] = np.asarray(v, np.float32)
    return out


def test_reference_checkpoint_serves_and_matches_jax(tmp_path):
    """model_dim 32, all 12 blocks and the full pools: the engine built
    from the ``.t7`` against the JAX model loaded through the JAX tool; a
    port checkpoint of the engine's model serves the same logits bit for
    bit; without a file the engine is ``build``'s."""
    name, kw = "scanobject_classifier_scales", dict(model_dim=32)
    rs = np.random.RandomState(1)
    sd = synth_reference_classifier_sd(np.random.RandomState(0),
                                       model_dim=32)
    # the mask head sees the trunk's 32 channels beside the class vector
    sd["mask_head.1.weight"] = rs.randn(256, 32 + 1024, 1)
    sd = _scaled(_with_scales(sd, rs), rs)
    params, stats = jax_tool(name, sd)
    pcd = rs.uniform(-1, 1, (1, 64, 3)).astype(np.float32)
    jm = jax_model(name, remat=False, **kw)
    j_logits, j_mask, _ = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(pcd))

    t7 = tmp_path / "classifier_scales.t7"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, t7)
    buckets = dict(batch_buckets=(1,), point_buckets=(64,))
    engine = InferenceEngine.from_checkpoint(name, str(t7), device="cpu",
                                             **buckets, **kw)
    (t_logits, t_mask, _), *_ = engine.predict_padded([pcd[0]])
    for ref, got in ((j_logits, t_logits), (j_mask, t_mask)):
        a = np.asarray(ref, np.float64).ravel()
        b = got.numpy().astype(np.float64).ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        p50 = np.median(np.abs(a - b)) / max(1.0, np.abs(a).max())
        assert np.isfinite(b).all() and cos > 0.999 and p50 <= 1e-3, (
            cos, p50)

    pt = tmp_path / "params.pt"
    save_params_only(engine.model, str(pt))
    again = InferenceEngine.from_checkpoint(name, str(pt), device="cpu",
                                            **buckets, **kw)
    (logits, mask, _), *_ = again.predict_padded([pcd[0]])
    assert torch.equal(logits, t_logits) and torch.equal(mask, t_mask)

    fresh = InferenceEngine.from_checkpoint(name, seed=3, device="cpu",
                                            **buckets, **kw)
    built = InferenceEngine.build(name, seed=3, device="cpu", **buckets,
                                  **kw)
    a, b = fresh.model.state_dict(), built.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b)


TINY_INPAINTER = dict(num_latent=16, model_dim=32, latent_width=24,
                      encoder_repeats=1, decoder_repeats=1,
                      stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),),
                      pool_heads=2, pool_feature_dims=(4, 4),
                      pool_sizes=(4, 8), trunk_width=8)
TINY_PLAN = (((4, 4), (2, 2), (16, 8), (2, 3)),)


def _tiny_t7(name, tmp_path, **kw):
    """A randomly initialised port model's weights written as the
    reference would hold them; -> (path, the port state)."""
    model = init_model_(get_model(name, **kw),
                        torch.Generator().manual_seed(5))
    state = model.state_dict()
    path = tmp_path / f"{name}.t7"
    torch.save({k: torch.from_numpy(v) for k, v in
                chip_smoke.reference_layout(name, state).items()}, path)
    return path, state


def _config(tmp_path, base, data, model):
    with open(os.path.join(ROOT, "configs", base)) as fh:
        cfg = yaml.safe_load(fh)
    cfg["experiment"] = {"root": str(tmp_path / "exp")}
    cfg["data"].update(data)
    cfg["model"].update(model)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _spy_evaluate(monkeypatch, module):
    """Keep the model that the command line hands to ``evaluate``."""
    seen = []
    real = module.evaluate

    def spy(model, *a, **kw):
        seen.append(model)
        return real(model, *a, **kw)
    monkeypatch.setattr(module, "evaluate", spy)
    return seen


def _same_state(model, state):
    got = model.state_dict()
    assert set(got) == set(state)
    assert all(torch.equal(got[k], state[k]) for k in state)


def test_eval_inpainting_from_a_reference_checkpoint(tmp_path, monkeypatch):
    from cloud_transformers_tpu_torch import eval_inpainting
    t7, state = _tiny_t7("completion_inpainter", tmp_path, **TINY_INPAINTER)
    cfg = _config(tmp_path, "inpainting.yaml",
                  dict(input_size=64, gt_size=128), TINY_INPAINTER)
    seen = _spy_evaluate(monkeypatch, eval_inpainting)
    per_cat = eval_inpainting.main(["x", "-c", cfg, "--synthetic", "--ckpt",
                                    str(t7), "--limit", "2", "--device",
                                    "cpu"])
    _same_state(seen[0], state)
    scores = [f for m in per_cat.values() for f in m["f"]]
    assert len(scores) == 2 and all(0.0 <= f <= 1.0 for f in scores)


def test_eval_reconstruction_from_a_reference_checkpoint(tmp_path,
                                                         monkeypatch):
    """One TINY decoder stage (the model has no depth keys) and the whole
    ResNet-50, whose blocks the reference names by torchvision's stages."""
    from cloud_transformers_tpu_torch import eval_reconstruction_f1
    monkeypatch.setattr(trec_mod, "AdaInDecoder",
                        lambda dim, latent, repeats, plan: AdaInDecoder(
                            dim, latent, 1, TINY_PLAN))
    widths = dict(num_latent=16, model_dim=32)
    t7, state = _tiny_t7("image_reconstructor", tmp_path, **widths)
    cfg = _config(tmp_path, "reconstruction.yaml",
                  dict(batch_size_val=2, im_size=32), widths)
    seen = _spy_evaluate(monkeypatch, eval_reconstruction_f1)
    per_class = eval_reconstruction_f1.main(
        ["x", "-c", cfg, "--synthetic", "--ckpt", str(t7), "--limit", "2",
         "--points", "64", "--device", "cpu"])
    _same_state(seen[0], state)
    scores = [f for m in per_class.values() for f in m["f"]]
    assert scores and all(0.0 <= f <= 1.0 for f in scores)
