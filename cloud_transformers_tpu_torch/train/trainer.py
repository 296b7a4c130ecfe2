"""Trainer: train step, eval step, epoch loop, validation, on one device or
one device a process.

Counterpart of ``cloud_transformers_tpu/train/trainer.py``.
A task provides ``loss_fn(model, batch) -> (loss, aux_metrics)``; the
trainer moves each numpy batch to the device, runs forward, backward and the
optimizer step, and keeps the metrics on the device until a window of
``show_each`` steps is averaged on the host.  Weights are initialised from
``seed`` through an explicit ``torch.Generator``; ``seed`` plus the
process's rank also seeds PyTorch's generators, which dropout draws from.

Across processes (a ``torch.distributed`` group of more than one rank; the
JAX package's 'data' mesh axis), each rank trains on its device with its
rows of the global batch (``data.DataLoader``'s ``process_index``):
parameters and buffers are broadcast from rank 0 once the weights are
made, loaded or resumed (JAX's ``replicate``); after the backward the
gradients are all-reduced in one flat buffer and divided by the world
size, before ``grad_stats``, clipping and the update, so every rank takes
the same step (the gradient of the global mean loss where each rank's loss
is the mean of its rows: a task with another normaliser makes it global,
as ``tasks/segmentation_kpconv.py`` does); BatchNorm's statistics are the
global batch's (``nn/norm.py``).  This is an explicit all-reduce, not
``DistributedDataParallel``: ``self.model`` stays the bare module (its
``state_dict`` names, the hooks), one code path serves NCCL and gloo on
CUDA tensors, and nothing has to follow the checkpointed regions of
``nn/remat.py``.

``mesh`` (``parallel/mesh.make_mesh(n_data, n_points)``; the JAX
``Trainer``'s ``mesh=``) adds a points axis: the loader takes the data
row's rows (``distributed.process_rows`` under ``with mesh:``), each step
takes the batch of the row's first points rank (``mesh.broadcast_row``)
and this rank's block of every cloud's points (``shard_batch`` along axis
1), and the forward and backward run under the mesh, which the model
code reads (``parallel/constrain.py``).  The averaged gradient is the
world's sum over the world size, as without it; the replicated draws of
the dropout are seeded from the seed and the data index.  Only rank 0 writes checkpoints (a barrier follows each
save) and logs; every rank loads ``ckpt_latest`` and ``cfg['restore']``.
The ``show_each`` window means and the validation metrics are averaged
over the ranks (an eval hook sums its own counts) before rank 0 logs them
and the best-metric gates decide, so every rank decides alike.  Dropout
draws differ by rank (the JAX package draws one mask for the global
batch); a resumed multi-rank run reseeds them from the seed, the rank and
the step, since the checkpoint holds rank 0's generator states.

Checkpoints: ``fit`` saves ``ckpt_latest`` every ``save_each`` steps, every
``save_each_epoch`` epochs and when ``max_steps`` ends the run (unless
``train.save`` is false), with the model, the optimizer and its schedule,
the step and epoch counts and the states of the random generators (the
trainer's, PyTorch's global ones, and the task's ``generators``).  A new
``Trainer`` in an experiment directory that holds a ``ckpt_latest`` resumes
from it (unless ``train.auto_resume`` is false); the interrupted epoch
starts again from its first batch.

At run start (not after an auto-resume, which already carries trained
weights) ``cfg['restore']`` loads ``generator``'s parameters through
``restore_params_only`` and, with ``new_lr``, rebuilds the optimizer at
that learning rate, as the JAX trainer does.

Best-metric checkpoints, as in the JAX trainer: ``train.best_metric``
(default ``loss``) and the keys of ``train.best_metrics`` are scored at
every validation (``-loss`` for ``loss``, the value itself for any other
key, ``-inf`` where the key is missing); where a score rises above its best
of this ``fit`` call, the checkpoint is saved as ``ckpt_best`` for the
first key and ``ckpt_<key>_best`` for the others (``m_acc`` written
``macc``), unless ``train.save`` is false.  The bests start at ``-inf``
when ``fit`` starts and are not restored on resume.

Logging, as in the JAX trainer: a ``MetricLogger`` (TensorBoard where
tensorboardX imports, always ``metrics.jsonl`` in the writer directory, and
a copy of ``config_path`` in the experiment directory) takes the window
means of the ``train/`` scalars every ``show_each`` steps, with
``steps_per_sec`` and the ``data_time``/``batch_time`` split (host seconds
a step waiting for the loader and in ``train_step``, which launches the
step's work and does not wait for the device: the lengths of the
``loader.next`` and ``trainer.step`` spans of ``utils/trace.py``), and the
``val/`` metrics of every validation and of ``epoch_hook(epoch)``, which
``fit`` calls after each validation epoch.  ``train.grad_stats`` adds ``grad_norm`` (the norm
of all gradients) and ``grad_norm/<name>`` per parameter to each step's
metrics, computed on the device without waiting for it.
``train.profile_step`` starts a ``torch.profiler`` trace at that global
step for ``train.profile_steps`` steps (default 5), written as a Chrome
trace under ``{exp_dir}/profile``; the tracer records while it runs, and
its spans go beside the trace as ``spans_step<N>[_rank<r>].json``, on the
clock of the trace's device timestamps.  ``mesh_hook(trainer, batch)``
runs every ``train.mesh_each`` steps (default 100).

Spans (``utils/trace.py``): ``train_step`` is ``trainer.step``, made of
``trainer.to_device``, ``trainer.forward`` (zeroing the gradients, then
the loss), ``trainer.backward`` and ``trainer.update`` (the averaged
gradients, ``grad_stats``, clipping, the optimizer and its schedule);
``setup.weights`` covers a fresh start's weights and optimizer.

An auto-resume that fails is tried once more.  If it fails again on a file
that cannot be this run's checkpoint (torn or foreign, a missing key, a
state that does not fit the model or the optimizer; see
``unreadable_checkpoint``), ``ckpt_latest`` is moved to
``ckpt_latest_unreadable_<time>`` and the run starts fresh; any other error
(I/O, out of memory) is raised.
"""

import contextlib
import json
import os
import pickle
import time
import zipfile

import numpy as np
import torch

from cloud_transformers_tpu_torch.nn.init import init_model_
from cloud_transformers_tpu_torch.nn.precision import strict_f32
from cloud_transformers_tpu_torch.parallel import distributed as pdist
from cloud_transformers_tpu_torch.parallel.mesh import (
    broadcast_row,
    shard_batch,
)
from cloud_transformers_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_params_only,
)
from cloud_transformers_tpu_torch.train.config import experiment_dirs
from cloud_transformers_tpu_torch.train.logging import (
    MetricLogger,
    setup_logger,
)
from cloud_transformers_tpu_torch.train.optim import make_optimizer
from cloud_transformers_tpu_torch.utils import trace

logger = setup_logger()

# what ``torch.load`` and ``load_state_dict`` raise on a file that is torn,
# foreign or of another model
_UNREADABLE = (pickle.UnpicklingError, EOFError, KeyError, ValueError,
               TypeError)
_UNREADABLE_RUNTIME = ("PytorchStreamReader", "Invalid magic number",
                       "Error(s) in loading state_dict",
                       "Weights only load failed")


def _torn_archive(path):
    """Whether the file at ``path`` is there but is no whole zip archive
    (the format ``torch.save`` writes); False where it cannot be read."""
    try:
        with zipfile.ZipFile(path) as archive:
            return archive.testzip() is not None
    except zipfile.BadZipFile:
        return True
    except OSError:
        return False


def unreadable_checkpoint(err, path=None):
    """Whether ``err``, raised while the checkpoint at ``path`` was loaded,
    says that the file cannot be this run's checkpoint, rather than that
    reading it failed (I/O, out of memory).  Torch's zip reader reports
    some torn files as ``OSError`` (EINVAL): an ``OSError`` counts only
    where the file is no whole zip archive."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(err, _UNREADABLE):
        return True
    if isinstance(err, OSError):
        return path is not None and os.path.isfile(path) and \
            _torn_archive(path)
    return isinstance(err, RuntimeError) and any(
        m in str(err) for m in _UNREADABLE_RUNTIME)


class Trainer:
    def __init__(self, model, cfg, exp_name, loss_fn, eval_fn=None,
                 device="cuda", seed=0, generators=None, config_path=None,
                 mesh=None):
        """``generators``: {name: torch.Generator} of the task (the noise
        of a loss function, say), saved and restored with a checkpoint.
        ``config_path``: the config file, copied into the experiment
        directory.  ``mesh``: a ``parallel/mesh.Mesh`` over the world,
        whose points axis splits every cloud's points."""
        self.cfg = cfg
        self.mesh = mesh
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn or loss_fn
        self.device = torch.device(device)
        if self.device.type == "cuda":
            strict_f32()
        self.logger = logger
        self.seed = seed
        self.rank = pdist.rank()
        self.world = pdist.world_size()
        self.is_main = self.rank == 0
        self.model = model
        self.generators = dict(generators or {})
        self._initial_generators = {k: g.get_state()
                                    for k, g in self.generators.items()}
        self._fresh_start()
        self.exp_dir, self.writer_dir = experiment_dirs(cfg, exp_name)
        self.metrics = MetricLogger(self.writer_dir, self.exp_dir,
                                    config_path,
                                    is_main_process=self.is_main)
        self.ckpt = CheckpointManager(self.exp_dir)
        resumed = (bool(cfg.get("train", {}).get("auto_resume", True))
                   and self.ckpt.exists("latest") and self._auto_resume())
        restore = cfg.get("restore") or {}
        if restore.get("generator"):
            if resumed:
                logger.info("skipping cfg['restore'] (%s): the run resumed "
                            "from ckpt_latest", restore["generator"])
            else:
                self.restore(restore["generator"], restore.get("new_lr"))
        self._replicate()

    def _replicate(self):
        """Every rank's parameters and buffers as rank 0's."""
        pdist.broadcast_tensors_(
            [p.data for p in self.model.parameters()]
            + list(self.model.buffers()))

    def _fresh_start(self):
        """Weights, optimizer, counters and generators as a new run has
        them."""
        self.generator = torch.Generator().manual_seed(self.seed)
        torch.manual_seed(self.seed + self.rank)
        if self.mesh is not None:
            self.mesh.seed(self.seed)
        for k, g in self.generators.items():
            g.set_state(self._initial_generators[k])
        with trace.span("setup.weights"):
            init_model_(self.model, self.generator)
            self.model = self.model.to(self.device)
            self.optimizer = make_optimizer(self.cfg["train"],
                                            self.model.named_parameters())
        self.global_step = 0
        self.epoch = 0

    def _auto_resume(self):
        """Resume from ``ckpt_latest``, with one retry.  -> whether it
        resumed; quarantines an unreadable checkpoint and starts fresh, and
        raises any other error."""
        for attempt in (0, 1):
            try:
                self.load_checkpoint(self.ckpt.restore("latest"))
            except Exception as e:
                err = e
                if attempt == 0:
                    logger.warning("auto-resume attempt failed (%s); "
                                   "retrying", e)
                continue
            logger.info("resumed from %s (step %d, epoch %d)",
                        self.ckpt.path("latest"), self.global_step,
                        self.epoch)
            return True
        if not unreadable_checkpoint(err, self.ckpt.path("latest")):
            raise err
        quarantine = self.ckpt.path(f"latest_unreadable_{int(time.time())}")
        pdist.barrier()   # every rank has given up on the file
        if self.is_main:
            try:
                os.rename(self.ckpt.path("latest"), quarantine)
            except OSError:
                quarantine = "<rename failed>"
        pdist.barrier()
        logger.error("AUTO-RESUME FAILED: ckpt_latest could not be restored "
                     "(%s). It was moved to %s; training restarts from "
                     "scratch.", err, quarantine)
        # a load that failed part of the way may have changed some state
        self._fresh_start()
        return False

    def restore(self, path, new_lr=None):
        """Load the parameters at ``path`` (any file
        ``restore_params_only`` reads) and, if ``new_lr`` is given, start a
        fresh optimizer at that learning rate."""
        restore_params_only(path, self.model)
        logger.info("restored params from %s", path)
        if new_lr is not None:
            tcfg = self.cfg["train"]
            self.optimizer = make_optimizer(
                dict(tcfg, optimizer=dict(tcfg.get("optimizer", {}),
                                          lr=float(new_lr))),
                self.model.named_parameters())

    # --- checkpoints -----------------------------------------------------
    def checkpoint(self):
        """Everything a resumed run needs, as one dict of tensors, numbers
        and lists."""
        rng = {"trainer": self.generator.get_state(),
               "torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        rng.update({f"task.{k}": g.get_state()
                    for k, g in self.generators.items()})
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.optimizer.state_dict(),
                "scheduler": self.optimizer.scheduler.state_dict(),
                "meta": {"global_step": self.global_step,
                         "epoch": self.epoch},
                "generators": rng}

    def load_checkpoint(self, payload):
        self.model.load_state_dict(payload["model"], strict=True)
        self.optimizer.optimizer.load_state_dict(payload["optimizer"])
        self.optimizer.scheduler.load_state_dict(payload["scheduler"])
        self.global_step = int(payload["meta"]["global_step"])
        self.epoch = int(payload["meta"]["epoch"])
        rng = payload["generators"]
        self.generator.set_state(rng["trainer"].cpu())
        torch.set_rng_state(rng["torch"].cpu())
        if self.device.type == "cuda" and "cuda" in rng:
            torch.cuda.set_rng_state(rng["cuda"].cpu(), self.device)
        for k, g in self.generators.items():
            g.set_state(rng[f"task.{k}"].cpu())
        if self.world > 1:
            # the saved states are rank 0's: dropout differs by rank again
            torch.manual_seed(self.seed + self.rank
                              + 1000003 * self.global_step)
            if self.mesh is not None:
                self.mesh.seed(self.seed + 1000003 * self.global_step)

    def save(self, tag="latest"):
        """Rank 0 writes the checkpoint; every rank waits for it.  -> its
        path."""
        path = self.ckpt.path(tag)
        if self.is_main:
            path = self.ckpt.save(self.checkpoint(), tag)
        pdist.barrier()
        return path

    def to_device(self, batch):
        """Numpy batch -> tensors on the device (labels as int64)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _on_mesh(self):
        """The mesh as the ambient one, where there is a mesh."""
        return self.mesh if self.mesh is not None else \
            contextlib.nullcontext()

    def _points_block(self, batch):
        """Under a points axis, this rank's block of the points of the
        batch that its data row's first points rank holds; ``batch``
        itself otherwise."""
        if self.mesh is None or self.mesh.n_points == 1:
            return batch
        return shard_batch(self.mesh, broadcast_row(self.mesh, batch),
                           points_axis=1, global_rows=False)

    # --- steps -----------------------------------------------------------
    def train_step(self, batch):
        """One optimizer step; -> metrics as 0-dim tensors on the device
        (plus ``pred``), not yet synchronised."""
        with trace.span("trainer.step"):
            self.model.train()
            with trace.span("trainer.to_device"):
                batch = self.to_device(self._points_block(batch))
            with trace.span("trainer.forward"), self._on_mesh():
                self.optimizer.zero_grad()
                loss, aux = self.loss_fn(self.model, batch)
            with trace.span("trainer.backward"), self._on_mesh():
                loss.backward()
            with trace.span("trainer.update"):
                self.average_gradients()
                metrics = {"loss": loss.detach(), **aux}
                if self.cfg.get("train", {}).get("grad_stats"):
                    metrics.update(self.grad_stats())
                self.optimizer.step()
                self.global_step += 1
            return metrics

    @torch.no_grad()
    def average_gradients(self):
        """Across processes, every gradient becomes the mean of the ranks'
        (one all-reduce of a flat buffer; a parameter that has no gradient
        on this rank adds zeros and keeps none, and the models' structure
        is the same on every rank); the identity on one process."""
        if not pdist.is_distributed():
            return
        params = [p for p in self.model.parameters() if p.requires_grad]
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        pdist.all_reduce_(flat, "sum").div_(self.world)
        i = 0
        for p in params:
            if p.grad is not None:
                p.grad.copy_(flat[i:i + p.numel()].view_as(p))
            i += p.numel()

    @torch.no_grad()
    def grad_stats(self):
        """{``grad_norm``: the norm of all gradients, ``grad_norm/<name>``:
        each parameter's}, 0-dim tensors on the device (no wait for it); a
        parameter without a gradient counts 0."""
        named = [(n, p.grad) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        grads = [g for _, g in named if g is not None]
        norms = iter(torch._foreach_norm(grads)) if grads else iter(())
        zero = torch.zeros((), device=self.device)
        out = {f"grad_norm/{n}": (next(norms) if g is not None else zero)
               for n, g in named}
        out["grad_norm"] = torch.linalg.vector_norm(
            torch.stack(list(out.values()))) if out else zero
        return out

    @torch.no_grad()
    def eval_step(self, batch):
        self.model.eval()
        with self._on_mesh():
            loss, aux = self.eval_fn(self.model,
                                     self.to_device(self._points_block(batch)))
        return {"loss": loss, **aux}

    # --- loop ------------------------------------------------------------
    def fit(self, train_loader, val_loader=None, eval_hook=None,
            num_epochs=None, max_steps=None, epoch_hook=None,
            mesh_hook=None):
        """The epoch loop: a host-side metric window every ``show_each``
        steps (logged under ``train/``), ``mesh_hook(self, batch)`` every
        ``mesh_each`` steps, ``ckpt_latest`` every ``save_each`` steps and
        ``save_each_epoch`` epochs, validation every ``val_step`` epochs
        with the best-metric checkpoints (logged under ``val/``), then
        ``epoch_hook(epoch)``, whose metrics are logged under ``val/`` too;
        a profiler trace from ``profile_step``; stop (and save) after
        ``max_steps`` optimizer steps if given.  -> the model."""
        tcfg = self.cfg["train"]
        num_epochs = num_epochs or int(tcfg.get("num_epochs", 1))
        show_each = int(tcfg.get("show_each", 100))
        val_step = int(tcfg.get("val_step", 1))
        save_each = int(tcfg.get("save_each", 0))
        save_each_epoch = int(tcfg.get("save_each_epoch", 1))
        save = bool(tcfg.get("save", True))
        profile_at = tcfg.get("profile_step")
        profile_end = (None if profile_at is None
                       else int(profile_at) + int(tcfg.get("profile_steps",
                                                           5)))
        mesh_each = int(tcfg.get("mesh_each", 100))
        keys = [tcfg.get("best_metric") or "loss"]
        keys += [k for k in tcfg.get("best_metrics") or [] if k not in keys]
        best = dict.fromkeys(keys, -np.inf)
        profiler = traced = None
        try:
            for epoch in range(self.epoch, num_epochs):
                self.epoch = epoch
                train_loader.set_epoch(epoch)
                t0 = time.time()
                window = []
                data_t, step_t = _waited()
                for batch in train_loader:
                    if profile_at is not None and \
                            self.global_step == int(profile_at):
                        profiler = self._profiler()
                        profiler.start()
                        traced = trace.enable(True)
                    # the window keeps the scalars only: a task's per-point
                    # outputs (``pred``, ``logits``) would pile up on the
                    # device for ``show_each`` steps
                    window.append({k: v for k, v in
                                   self.train_step(batch).items()
                                   if v.dim() == 0})
                    if profiler is not None and \
                            self.global_step >= profile_end:
                        profiler = self._stop_profile(profiler, traced)
                    if self.global_step % show_each == 0:
                        host = _window_mean(window, self.device)
                        n = len(window)
                        host["steps_per_sec"] = n / (time.time() - t0)
                        data_end, step_end = _waited()
                        host["data_time"] = (data_end - data_t) / n
                        host["batch_time"] = (step_end - step_t) / n
                        window, t0 = [], time.time()
                        data_t, step_t = data_end, step_end
                        self.metrics.scalars(self.global_step, host,
                                             prefix="train/")
                        if self.is_main:
                            logger.info(
                                "epoch %d step %d: %s", epoch,
                                self.global_step,
                                {k: round(v, 4) for k, v in host.items()
                                 if "/" not in k})
                    if mesh_hook is not None and mesh_each and \
                            self.global_step % mesh_each == 0:
                        mesh_hook(self, batch)
                    if save and save_each and \
                            self.global_step % save_each == 0:
                        self.save()
                    if max_steps and self.global_step >= max_steps:
                        if save:
                            self.save()
                        return self.model
                self.epoch = epoch + 1   # a resumed run starts the next epoch
                if save and (epoch + 1) % save_each_epoch == 0:
                    self.save()
                if val_loader is not None and (epoch + 1) % val_step == 0:
                    val = self.validate(val_loader, eval_hook)
                    self.metrics.scalars(self.global_step, val,
                                         prefix="val/")
                    if self.is_main:
                        logger.info("epoch %d val: %s", epoch,
                                    {k: round(float(v), 4)
                                     for k, v in val.items()})
                    for key in keys:
                        score = (-float(val.get("loss", np.inf))
                                 if key == "loss"
                                 else float(val.get(key, -np.inf)))
                        if save and score > best[key]:
                            best[key] = score
                            self.save("best" if key == keys[0] else
                                      f"{key.replace('m_acc', 'macc')}_best")
                if epoch_hook is not None and (epoch + 1) % val_step == 0:
                    hook_metrics = epoch_hook(epoch) or {}
                    if hook_metrics:
                        self.metrics.scalars(self.global_step, hook_metrics,
                                             prefix="val/")
        finally:
            if profiler is not None:
                self._stop_profile(profiler, traced)
        return self.model

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def _stop_profile(self, profiler, traced):
        """Wait for the device, stop the trace and the tracer (back to
        ``traced``, its state before) and write both to
        ``{exp_dir}/profile``.  -> None."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        spans = trace.take()
        trace.enable(traced)
        out = os.path.join(self.exp_dir, "profile")
        os.makedirs(out, exist_ok=True)
        name = f"step{self.global_step}"
        if self.world > 1:
            name += f"_rank{self.rank}"
        path = os.path.join(out, f"trace_{name}.json")
        profiler.export_chrome_trace(path)
        with open(os.path.join(out, f"spans_{name}.json"), "w") as f:
            json.dump({"clock": "time.time_ns", **spans}, f)
        logger.info("profiler trace and spans written to %s", out)
        return None

    def validate(self, val_loader, eval_hook=None):
        """Average the eval metrics over the loader (and over the ranks'
        loaders).  ``eval_hook(batch, metrics)`` may accumulate task
        statistics; if it has ``compute()``, its results are merged into
        (and override) the returned metrics."""
        if eval_hook is not None and self.mesh is not None and \
                self.mesh.n_points > 1:
            raise ValueError("an eval hook reads the data row's batch beside "
                             "this rank's block of the points: validate "
                             "with hooks on a mesh without a points axis")
        if eval_hook is not None and hasattr(eval_hook, "reset"):
            eval_hook.reset()
        sums, count = {}, 0
        for batch in val_loader:
            m = self.eval_step(batch)
            if eval_hook is not None:
                eval_hook(batch, m)
            for k, v in m.items():
                if v.dim() == 0:
                    sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        if pdist.is_distributed():
            keys = list(sums)
            total = pdist.all_reduce_array(
                np.array([sums[k] for k in keys] + [count], np.float64))
            sums, count = dict(zip(keys, total[:-1])), total[-1]
        out = {k: float(v / max(count, 1)) for k, v in sums.items()}
        if eval_hook is not None and hasattr(eval_hook, "compute"):
            out.update(eval_hook.compute())
        return out


def _waited():
    """(seconds this thread has waited on a loader, seconds it has spent in
    ``train_step``), from the spans' totals."""
    return trace.seconds("loader.next"), trace.seconds("trainer.step")


def _window_mean(window, device):
    """Mean of each scalar metric over a window of steps, on the host (one
    copy from the device for the whole window), and across processes over
    the ranks (one all-reduce on ``device``)."""
    keys = [k for k, v in window[0].items() if v.dim() == 0]
    if not keys:
        return {}
    values = torch.stack([torch.stack([m[k].float() for k in keys])
                          for m in window]).cpu().double().mean(0)
    if pdist.is_distributed():
        values = pdist.all_reduce_(values.to(device), "mean").cpu()
    return dict(zip(keys, values.tolist()))
