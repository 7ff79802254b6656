"""Training runtime (port of ``rot_mvgaze_tpu/train/trainer.py``, stereo and
V-view, on one process or data-parallel over several).

- :func:`make_optimizer`: ``torch.optim.Adam`` with coupled L2.
- :class:`Trainer`: evaluation before the first epoch and after each one,
  the train step with every option the JAX Trainer uses (augmentation draws
  folded by the update count, previews for TensorBoard, ``grad_accum``,
  ``ema_decay``, ``freeze_bn``), checkpoints with full-state and step-exact
  mid-epoch resume, a save at the next step boundary on SIGTERM or SIGINT,
  a TensorBoard event file, ``test_results.txt`` and a config snapshot.

It also starts from the JAX package's ``.msgpack`` checkpoints (a full
``TrainState`` continues its run: Adam's moments, the step, the moving
average and the epoch position) and from an ImageNet backbone
(``pretrained_backbone``), and exports the bare reference state dict
(:meth:`Trainer.export_torch_checkpoint`).

With ``num_views > 2`` in the config it trains ``FeatRotationMultiView``
through the V-view steps (``train/multiview_steps.py``) and scores view 0.

Under data parallelism (a process group from ``parallel.initialize``, one
card per process) rank 0's weights, optimizer state, moving average, step
and epoch position reach every rank at the start; each rank trains on its
shard of the data with the global batch's BatchNorm statistics and averaged
gradients (``make_train_step(group=)``); a preemption signal on any rank
stops every rank at the same step; the evaluation's mean error is the
global one; rank 0 alone writes checkpoints, logs and TensorBoard.

``profile_steps`` N takes one ``torch.profiler`` trace of the N train steps
after the first (which pays the start-up), with the device synchronised at
both edges of the window, into ``profile_dir`` (default
``<output_dir>/profile``; one ``host_{rank:02d}`` directory per process
under data parallelism), as one Chrome trace file per process.

Not ported yet: meshes and spatial partitioning (ROADMAP A13).
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
import signal
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from rot_mvgaze_tpu_torch import parallel
from rot_mvgaze_tpu_torch.compat.convert import (
    checkpoint_state_dict,
    is_jax_tree,
    model_config,
    read_checkpoint,
    state_from_jax,
)
from rot_mvgaze_tpu_torch.compat.pretrained import load_pretrained_backbone, resolve_pretrained
from rot_mvgaze_tpu_torch.data.pipeline import device_prefetch
from rot_mvgaze_tpu_torch.evaluate import (
    EVAL_KEYS,
    MULTIVIEW_EVAL_KEYS,
    breakdown_from_errors,
    eval_predictions,
    format_breakdown,
)
from rot_mvgaze_tpu_torch.geometry.gaze import angular_error_numpy
from rot_mvgaze_tpu_torch.train.checkpoints import (
    CHECKPOINT_GLOB,
    RESUME_GLOBS,
    find_latest_checkpoint,
    is_full_state,
    save_state,
)
from rot_mvgaze_tpu_torch.train.multiview_steps import make_multiview_eval_step, make_multiview_train_step
from rot_mvgaze_tpu_torch.train.schedule import cyclic_triangular2
from rot_mvgaze_tpu_torch.train.steps import init_ema, make_eval_step, make_train_step
from rot_mvgaze_tpu_torch.train.tb import NullSummaryWriter, SummaryWriter, make_image_grid
from rot_mvgaze_tpu_torch.utils.device import resolve_device
from rot_mvgaze_tpu_torch.utils.profiling import StepTimer
from rot_mvgaze_tpu_torch.utils.seed import set_seed
from rot_mvgaze_tpu_torch.utils.summary import count_parameters, parameter_table


def make_optimizer(
    params: Iterable[torch.nn.Parameter], weight_decay: float = 1e-6, lr: float = 0.0
) -> torch.optim.Adam:
    """``torch.optim.Adam`` with coupled L2 (the decay is added to the gradient
    before the moments), the reference's optimizer and what the JAX
    package's ``add_decayed_weights -> scale_by_adam -> scale_by_learning_rate``
    chain computes. The train step sets ``lr`` from its schedule before each
    update."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


class Trainer:
    """Trains and evaluates a ``FeatRotationSymm`` (or, with ``num_views >
    2``, a ``FeatRotationMultiView``) on one device.

    ``config`` is any object with attributes (a ``SimpleNamespace`` or the
    CLI's namespace); the Trainer reads ``mode`` (``train``/``test``),
    ``output_dir``, ``ckpt_resume``, ``auto_resume_dir``, ``weights_only``,
    ``epochs``, ``save_epoch``, ``print_freq``, ``seed``, ``image_size``,
    ``scheduler_step`` (``epoch``, the reference's, or
    ``iteration``), ``base_lr``, ``max_lr``, ``weight_decay``, ``bf16``
    (bf16 autocast in the train step), ``grad_accum``, ``ema_decay``,
    ``freeze_bn``, ``keep_last_n``, ``num_views``, ``profile_steps`` and
    ``profile_dir``, each with the JAX Trainer's default where it is
    absent. ``num_views > 2`` selects the
    V-view steps: batches of ``MultiViewGazeDataset``, no ``grad_accum``,
    images/s counting V images per sample, and the metric on view 0.

    ``model`` brings its own weights; ``init_state_dict`` loads others
    first, then ``pretrained_backbone`` (a torchvision ResNet file, or
    ``auto`` for the cached one) the backbone's, and a checkpoint
    (``ckpt_resume`` or the newest ``*.pth.tar`` in ``auto_resume_dir``)
    after that. A checkpoint is the port's, a reference state dict or the
    JAX package's ``.msgpack``, told apart by its contents; a full training
    state (the port's, or a JAX ``TrainState``: ``opt_state`` in the tree)
    continues its run unless ``weights_only``, and a weights-only load takes
    the moving average when there is one. The model moves to ``device`` (the
    card unless the caller asks for the CPU). Evaluation always runs in
    float32, on the moving average of the parameters when there is one.
    ``step`` counts the updates made (the JAX package's ``state.step``); it
    is the schedule's count, the augmentation draws' fold and TensorBoard's
    x-axis.
    """

    def __init__(
        self,
        config: Any,
        model: nn.Module,
        metrics: Any,
        train_loader: Optional[Any] = None,
        test_loader: Optional[Any] = None,
        device: Any = "cuda",
        init_state_dict: Optional[Dict[str, torch.Tensor]] = None,
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.metrics = metrics
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.image_size = int(getattr(config, "image_size", 224))
        self.mode = getattr(config, "mode", "train")
        self._ema_decay = float(getattr(config, "ema_decay", 0.0) or 0.0)
        self.compute_dtype = torch.bfloat16 if getattr(config, "bf16", False) else torch.float32
        self.num_views = int(getattr(config, "num_views", 2) or 2)
        self.rank, self.world = parallel.process_index(), parallel.process_count()
        self.group = parallel.device_group()
        self._is_primary = self.rank == 0

        # ---- weights ----
        ckpt_resume = getattr(config, "ckpt_resume", None)
        auto_dir = getattr(config, "auto_resume_dir", None)
        if ckpt_resume is None and auto_dir:
            ckpt_resume = find_latest_checkpoint(auto_dir) if self._is_primary else None
            if self.world > 1:  # rank 0's find: another rank may not see the directory
                ckpt_resume = parallel.broadcast_object(ckpt_resume)
            if ckpt_resume:
                print(f"auto-resume from latest checkpoint: {ckpt_resume}")
        if self.mode == "test" and ckpt_resume is None and init_state_dict is None:
            # scoring the model's initial weights is never what test mode means
            raise FileNotFoundError(
                "mode test needs a checkpoint, but none was found: ckpt_resume="
                f"{getattr(config, 'ckpt_resume', None)!r}, auto_resume_dir={auto_dir!r} "
                f"holds no {' or '.join(RESUME_GLOBS)}"
            )
        self._weights_only = bool(getattr(config, "weights_only", False))
        if self._weights_only and auto_dir:
            # auto-resume continues a run (optimizer state and step); a
            # weights-only start drops exactly those, on every restart
            raise ValueError(
                "weights_only contradicts auto_resume_dir: auto-resume continues a run "
                "(optimizer state and step); a weights-only warm start discards them"
            )
        self._resume_path = ckpt_resume
        pretrained = getattr(config, "pretrained_backbone", None)
        warm_start = ckpt_resume is not None or init_state_dict is not None or bool(pretrained)
        if init_state_dict is not None:
            model.load_state_dict(init_state_dict, strict=True)
        # under data parallelism rank 0 alone reads files; the rest take its
        # state by broadcast (below)
        if pretrained and self._is_primary:
            pretrained = resolve_pretrained(pretrained, model.backbone_depth)
            load_pretrained_backbone(model, pretrained)
            print(f"backbone initialized from {pretrained}")
        ckpt, full = None, False
        if ckpt_resume and self._is_primary:
            print(f"load from ckpt: {ckpt_resume}")
            ckpt = read_checkpoint(ckpt_resume)
            if is_jax_tree(ckpt):
                ckpt = state_from_jax(
                    ckpt, [n for n, _ in model.named_parameters()], **model_config(model)
                )
            full = is_full_state(ckpt) and not self._weights_only
            # a weights-only start takes the moving average, the weights a
            # run evaluates; a full resume continues from the raw parameters
            model.load_state_dict(checkpoint_state_dict(ckpt, prefer_ema=not full), strict=True)
        self.model = model.to(device=self.device, memory_format=torch.channels_last)
        self.generator = set_seed(int(getattr(config, "seed", 0)), self.device)

        # ---- optimizer and schedule ----
        # len() counts a ragged last batch, as the reference's cycle does
        steps_per_epoch = max(len(train_loader), 1) if train_loader is not None else 1
        self.steps_per_epoch = steps_per_epoch
        step_size_up = max(steps_per_epoch // 2, 1)
        scheduler_step = getattr(config, "scheduler_step", "epoch")
        if scheduler_step not in ("epoch", "iteration"):
            raise ValueError(f"scheduler_step must be 'epoch' or 'iteration', got {scheduler_step!r}")
        self.schedule = cyclic_triangular2(
            base_lr=float(getattr(config, "base_lr", 1e-6)),
            max_lr=float(getattr(config, "max_lr", 1e-3)),
            step_size_up=step_size_up,
            step_size_down=max(steps_per_epoch - step_size_up, 1),
            # 'epoch': the reference steps its CyclicLR once per epoch
            steps_per_epoch=steps_per_epoch if scheduler_step == "epoch" else 1,
        )
        self.optimizer = make_optimizer(
            self.model.parameters(), float(getattr(config, "weight_decay", 1e-6))
        )
        self.step = 0
        self.ema = init_ema(self.model) if self._ema_decay > 0 else None
        resume_meta = None
        if full:
            # a state converted from JAX holds Adam's state alone; the
            # hyperparameters stay this run's
            self.optimizer.load_state_dict({**self.optimizer.state_dict(), **ckpt["optimizer"]})
            self.step = int(ckpt["step"])
            resume_meta = ckpt.get("epoch_meta")
            stored = ckpt.get("ema")
            if self._ema_decay > 0 and not stored:
                print("checkpoint has no EMA weights; seeding the EMA from its params", flush=True)
            elif stored and self._ema_decay == 0 and self.mode == "train":
                # a stored average would go stale, yet evaluation prefers it
                print("WARNING: checkpoint carries EMA weights but ema_decay is 0; dropping "
                      "them for this training run (set ema_decay to keep updating the average)",
                      flush=True)
            elif stored:
                self.ema = {n: stored[n].to(self.device) for n, _ in self.model.named_parameters()}
            print(f"restored full training state at step {self.step}")
        if self.world > 1:
            resume_meta = self._broadcast_state(resume_meta)
            parallel.set_batchnorm_group(self.model, self.group)

        # ---- outputs ----
        self.output_dir = getattr(config, "output_dir", "./logs")
        self.ckpt_dir = osp.join(self.output_dir, "ckpt")
        if self._is_primary:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            self.writer = SummaryWriter(osp.join(self.output_dir, "tensorboard"))
            with open(osp.join(self.output_dir, "config.yaml"), "w") as f:
                # JSON is YAML; the snapshot needs no YAML package
                json.dump({k: v for k, v in vars(config).items() if _jsonable(v)}, f, indent=1)
        else:
            self.writer = NullSummaryWriter()
        self.epochs = int(getattr(config, "epochs", 15))
        self.save_epoch = int(getattr(config, "save_epoch", 10))
        self.print_freq = int(getattr(config, "print_freq", 50))

        # ---- profiler window (profile_steps) ----
        self.profile_steps = int(getattr(config, "profile_steps", 0) or 0)
        profile_dir = getattr(config, "profile_dir", None)
        if profile_dir is not None and not self.profile_steps:
            raise ValueError("profile_dir needs profile_steps (how many steady-state train steps "
                             "to trace)")
        if self.profile_steps and profile_dir is None:
            profile_dir = osp.join(self.output_dir, "profile")
        if profile_dir is not None and self.world > 1:
            # one directory per process: each traces its own card
            profile_dir = osp.join(profile_dir, f"host_{self.rank:02d}")
        self._profile_dir = profile_dir
        self._profiler = None
        self._profile_left = 0
        self.profile_trace: Optional[str] = None
        self._exec_steps = 0  # train steps this process has run (the window's trigger)

        # ---- where a resume starts: (epochs done, batches of the next) ----
        self._start_epoch = 0
        self._start_batch = 0
        if resume_meta is not None:
            self._start_epoch = min(int(resume_meta["epochs_done"]), self.epochs)
            self._start_batch = max(int(resume_meta["epoch_step"]), 0)
            if self._start_batch and int(resume_meta["steps_per_epoch"]) != self.steps_per_epoch:
                # another batching of the epoch's order: the saved position
                # means nothing there, so the epoch restarts
                print("resume: steps_per_epoch changed "
                      f"({int(resume_meta['steps_per_epoch'])} at save time vs "
                      f"{self.steps_per_epoch} now) — the interrupted epoch restarts "
                      "from its first batch")
                self._start_batch = 0
            if self._start_epoch >= self.epochs:
                self._start_batch = 0
        elif self.step > 0:
            self._start_epoch = min(self.step // self.steps_per_epoch, self.epochs)
        if self._start_epoch > 0 and self.train_loader is not None:
            # continue the run's per-epoch shuffles, rng((seed, epoch))
            self.train_loader.epoch = self._start_epoch
        # the epoch position the next save records
        self._epoch_cur = self._start_epoch
        self._epoch_step = self._start_batch

        print(parameter_table(self.model))
        print(f"total params: {count_parameters(self.model):,}")

        # ---- steps ----
        freeze_bn = bool(getattr(config, "freeze_bn", False))
        if freeze_bn and not warm_start:
            print("WARNING: freeze_bn without a checkpoint or init_state_dict freezes BatchNorm "
                  "at its initial statistics (mean 0, var 1); it is meant for warm starts",
                  flush=True)
        grad_accum = int(getattr(config, "grad_accum", 1) or 1)
        if grad_accum > 1 and train_loader is not None:
            if train_loader.batch_size % grad_accum:
                raise ValueError(f"batch_size {train_loader.batch_size} not divisible by "
                                 f"grad_accum {grad_accum}")
            if not getattr(train_loader, "drop_last", False):
                raise ValueError("grad_accum > 1 requires a drop_last train loader (a ragged "
                                 "last batch cannot split into micro-batches)")
        step_options = dict(
            image_size=self.image_size, schedule=self.schedule, compute_dtype=self.compute_dtype,
            ema_decay=self._ema_decay, ema=self.ema if self._ema_decay > 0 else None,
            freeze_bn=freeze_bn, with_images=True, fold_key_by_step=True,
        )
        if self.num_views > 2:
            if grad_accum > 1:
                raise ValueError("grad_accum > 1 is not supported with num_views > 2")
            self._train_step = make_multiview_train_step(self.model, metrics, self.optimizer,
                                                         group=self.group, **step_options)
            self._eval_step = make_multiview_eval_step(self.model, self.image_size)
            self._eval_keys = MULTIVIEW_EVAL_KEYS
        else:
            self._train_step = make_train_step(self.model, metrics, self.optimizer,
                                               grad_accum=grad_accum, group=self.group,
                                               **step_options)
            self._eval_step = make_eval_step(self.model, self.image_size)
            self._eval_keys = EVAL_KEYS
        self._preempted = False

    def _broadcast_state(self, resume_meta: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """Rank 0's weights, buffers, optimizer state, moving average, step
        and epoch position on every rank (once, at the start): the ranks
        average gradients, never parameters, so they must start alike,
        also where only rank 0 could read the checkpoint. Returns the epoch
        position."""
        def cpu(tree):
            if isinstance(tree, torch.Tensor):
                return tree.detach().cpu()
            if isinstance(tree, dict):
                return {k: cpu(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(cpu(v) for v in tree)
            return tree

        state = None
        if self._is_primary:
            state = cpu({"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                         "ema": self.ema, "step": self.step, "epoch_meta": resume_meta})
        state = parallel.broadcast_object(state)
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if state["ema"] is not None:
            self.ema = {n: v.to(self.device) for n, v in state["ema"].items()}
        return state["epoch_meta"]

    # ------------------------------------------------------------------
    def train(self) -> float:
        """Evaluate, then train and evaluate each remaining epoch, saving every
        ``save_epoch`` epochs. SIGTERM or SIGINT saves the state at the next
        step boundary and returns nan."""
        self._preempted = False

        def on_signal(signum, frame):
            print(f"signal {signum}: checkpointing at next step boundary")
            self._preempted = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                pass
        try:
            start = self._start_epoch
            if start >= self.epochs and self.epochs > 0:
                print(f"resume: checkpoint already covers {self.epochs} epoch(s) "
                      f"(step {self.step}) — evaluating only")
            elif start > 0 or self._start_batch > 0:
                pos = f" from batch {self._start_batch + 1}" if self._start_batch > 0 else ""
                print(f"resume: {start} epoch(s) done (step {self.step}) — training epochs "
                      f"{start + 1}..{self.epochs}{pos}")
            error = self.test(-1)
            for epoch in range(start, self.epochs):
                if self._preempt_requested():  # the signal came during an eval
                    self.save_checkpoint(add=f"preempt_epoch_{epoch:02d}")
                    print("preempted: state saved, exiting train loop")
                    return float("nan")
                self.train_one_epoch(epoch)
                if self._preempt_requested():
                    self.save_checkpoint(add=f"preempt_epoch_{epoch:02d}")
                    print("preempted: state saved, exiting train loop")
                    return float("nan")
                error = self.test(epoch)
                if (epoch + 1) % self.save_epoch == 0:
                    self.save_checkpoint(add=f"epoch_{epoch + 1:02d}_error={round(error, 2)}")
            if self._preempt_requested():  # during the last eval: keep the promise
                self.save_checkpoint(add="preempt_final")
                print("preempted during final eval: state saved")
            if self.profile_steps and self.profile_trace is None:
                print("WARNING: profile_steps was set but no trace was captured (the run took "
                      "fewer than 2 train steps; the first step is left out of the window)")
            return error
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _preempt_requested(self) -> bool:
        """Whether to stop at this step boundary, the same answer on every
        rank: a signal reaches one process, and a rank that stopped alone
        would leave the others waiting in the next all-reduce (one flag
        exchange per call under data parallelism). The agreed answer is
        adopted, so that later checks see it on every rank."""
        if self.world > 1 and parallel.any_process(self._preempted):
            self._preempted = True
        return self._preempted

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._profiler = profile(activities=activities)
        self._profiler.start()
        self._profile_left = self.profile_steps

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        path = osp.join(self._profile_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        captured = self.profile_steps - self._profile_left
        self._profiler = None
        self.profile_trace = path
        print(f"profiler trace of {captured} train step(s) saved to {path} (chrome://tracing / "
              f"Perfetto)")

    def train_one_epoch(self, epoch: int) -> None:
        """One epoch of train steps, from the batch a mid-epoch resume left
        off at; every ``print_freq`` steps the loss, error, rate and images/s
        are printed and logged, with the step's previews."""
        print(f"Epoch: {epoch + 1} / {self.epochs}")
        if self.train_loader is None:
            raise ValueError("train_one_epoch needs a train_loader")
        skip = 0
        if epoch == self._start_epoch and self._start_batch > 0:
            skip, self._start_batch = self._start_batch, 0
            self.train_loader.skip_batches = skip
            print(f"resume: fast-forwarding epoch {epoch + 1} to batch "
                  f"{skip + 1}/{len(self.train_loader)}")
        self._epoch_cur, self._epoch_step = epoch, skip
        n_samples = last_n = 0
        timer = StepTimer()
        timer.start()
        preempted = False
        for batch in device_prefetch(iter(self.train_loader), self.device):
            if (self.profile_steps and self.profile_trace is None and self._profiler is None
                    and self._exec_steps == 1):
                self._start_profile()
            stats = self._train_step(batch, self.generator, step=self.step)
            self._exec_steps += 1
            if self._profiler is not None:
                self._profile_left -= 1
                if self._profile_left == 0:
                    self._stop_profile()
            self._epoch_step += 1
            n_samples += int((batch["imgs"] if "imgs" in batch else batch["img_0"]).shape[0])
            if self.step != 0 and self.step % self.print_freq == 0:
                ips = self.num_views * (n_samples - last_n) / max(timer.stop(stats), 1e-9)
                timer.start()
                last_n = n_samples
                loss, err = float(stats["loss_gaze"]), float(stats["error_gaze"])
                print(f"train iter {self.step}: loss_gaze={loss:.5f} error_gaze={err:.3f} "
                      f"lr={stats['lr']:.2e} imgs/s={ips:.0f}")
                for tag, value in (("imgs_per_sec", ips), ("loss_gaze", loss),
                                   ("error_gaze", err), ("lr", stats["lr"])):
                    self.writer.add_scalar(f"train/{tag}", value, self.step)
                for view in ("img_0", "img_1"):
                    self.writer.add_image(f"train/images_{view[-1]}",
                                          make_image_grid(stats[view].cpu().numpy()), self.step)
            self.step += 1
            if self._preempt_requested():
                preempted = True
                break
        if not preempted:  # the epoch is done: a save records the next one
            self._epoch_cur, self._epoch_step = epoch + 1, 0
        if self._profiler is not None:
            # the epoch (or a preemption) ended inside the window: close it
            self._stop_profile()
        self.writer.flush()

    def test(self, epoch: int) -> float:
        """Mean angular error (degrees, float64 on the host) over the test
        loader, appended to ``test_results.txt`` and logged at ``epoch + 1``."""
        if self.test_loader is None:
            raise ValueError("test needs a test_loader")

        def previews(i, out):
            if i != 0 and i % self.print_freq == 0:
                for view in ("img_0", "img_1"):
                    self.writer.add_image(f"test/images_{view[-1]}",
                                          make_image_grid(out[view].cpu().numpy()), i)

        pred, gt, idx_0 = eval_predictions(
            # the moving average when there is one, else the module's own
            self._eval_step, self.test_loader, self.device, self._eval_keys, self.ema, previews
        )
        n_test = (self.test_loader.num_samples() if hasattr(self.test_loader, "num_samples")
                  else len(self.test_loader.dataset))
        if pred.shape[0] != n_test:
            print(f"test saved {pred.shape[0]} != dataset size {n_test}")
        errors = angular_error_numpy(pred, gt)
        # kept for test_breakdown, which then needs no second pass
        self.last_eval = {"pred": pred, "errors": errors, "idx_0": idx_0,
                          "rows": self._loader_eval_rows(idx_0)}
        if self.world > 1:
            # every rank scored its shard: the global mean from the ranks'
            # (sum, count), the same on every rank
            total = torch.tensor([float(np.sum(errors)), float(errors.shape[0])], dtype=torch.float64)
            torch.distributed.all_reduce(total, group=parallel.host_group())
            avg_error = float(total[0] / total[1])
        else:
            avg_error = float(np.mean(errors))
        msg = f"test on epoch {epoch + 1}, error: {avg_error}\n"
        print(msg, end="")
        self.writer.add_scalar("test/epoch_error_gaze", avg_error, epoch + 1)
        if self._is_primary:
            with open(osp.join(self.output_dir, "test_results.txt"), "a") as f:
                f.write(msg)
        self.writer.flush()
        return avg_error

    def _loader_eval_rows(self, idx_0: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """The dataset rows the eval pass yielded, in order (the loader's
        ``last_epoch_order``), checked against the ``idx_0`` column; None
        where the loader or dataset does not expose them or they disagree."""
        ds = getattr(self.test_loader, "dataset", None)
        rows = getattr(self.test_loader, "last_epoch_order", None)
        if idx_0 is None or rows is None or not getattr(ds, "idx_to_kv", None):
            return None
        if len(rows) < idx_0.shape[0]:
            return None
        rows = np.asarray(rows)[: idx_0.shape[0]]
        # a V-view index entry holds all its views' rows: view 0's is first
        expect = np.asarray([np.ravel(ds.idx_to_kv[int(r)][1])[0] for r in rows], np.int64)
        return rows if np.array_equal(idx_0, expect) else None

    def test_breakdown(self) -> Dict[str, Any]:
        """Per-camera and per-subject errors of the last :meth:`test` (run
        first if there was none), appended to ``test_results.txt``."""
        if getattr(self, "last_eval", None) is None:
            self.test(-1)
        ev = self.last_eval
        errors, idx_0, rows = ev["errors"], ev["idx_0"], ev["rows"]
        if self.world > 1:
            # every rank's samples, in rank order; a rank without its rows
            # or indices leaves them out for all
            parts = parallel.all_gather_object((errors, idx_0, rows))
            errors = np.concatenate([p[0] for p in parts])
            idx_0 = None if any(p[1] is None for p in parts) else np.concatenate([p[1] for p in parts])
            rows = None if any(p[2] is None for p in parts) else np.concatenate([p[2] for p in parts])
        detail = breakdown_from_errors(
            errors, idx_0=idx_0, dataset=getattr(self.test_loader, "dataset", None), rows=rows,
        )
        report = format_breakdown(detail)
        if self.world > 1:
            report = f"[aggregated over {self.world} processes]\n" + report
        print(report, end="")
        if self._is_primary:
            with open(osp.join(self.output_dir, "test_results.txt"), "a") as f:
                f.write(report)
        return detail

    # ------------------------------------------------------------------
    def save_checkpoint(self, add: Optional[str] = None) -> str:
        """Save the full state to ``ckpt/<add>.pth.tar`` (see
        :mod:`rot_mvgaze_tpu_torch.train.checkpoints`), keeping the newest
        ``keep_last_n`` checkpoints when that is set. Under data parallelism
        rank 0 alone writes (the state is the same on every rank)."""
        path = osp.join(self.ckpt_dir, (add if add is not None else "ckpt") + ".pth.tar")
        if not self._is_primary:
            return path
        payload = {
            "state_dict": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "epoch_meta": {"epochs_done": int(self._epoch_cur), "epoch_step": int(self._epoch_step),
                           "steps_per_epoch": int(self.steps_per_epoch)},
        }
        if self.ema is not None:
            payload["ema"] = self._ema_by_key()
        save_state(path, payload)
        print(f"save file to: {path}")
        keep = int(getattr(self.config, "keep_last_n", 0) or 0)
        if keep > 0:
            ckpts = sorted(glob.glob(osp.join(self.ckpt_dir, CHECKPOINT_GLOB)), key=osp.getmtime)
            for old in ckpts[:-keep]:
                os.remove(old)
        return path

    def export_torch_checkpoint(self, path: str) -> str:
        """Save the bare reference state dict (the moving average's weights
        when there is one, the weights :meth:`test` scores) to ``path``: the
        file ``GazePredictor`` and the reference load with ``strict=True``
        (rank 0 alone writes it)."""
        if not self._is_primary:
            return path
        sd = self.model.state_dict()
        if self.ema is not None:
            sd.update(self._ema_by_key())
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()}, path)
        return path

    def _ema_by_key(self) -> Dict[str, torch.Tensor]:
        """The moving average by state-dict key, aliases of a shared
        parameter included, so that it overlays the state dict as it is."""
        first: Dict[int, str] = {}
        return {n: self.ema[first.setdefault(id(p), n)]
                for n, p in self.model.named_parameters(remove_duplicate=False)}


def _jsonable(v: Any) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False
