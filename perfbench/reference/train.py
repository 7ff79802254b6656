"""The reference's first training steps of the stereo model, in float32.

Each step: the train augmentation of both views from the step's folded
seed, head poses to rotations, the train forward (one backbone pass per
view, statistics per view), the iteration loss, the backward, and Adam at
the schedule's rate. To fit a card at the timed batch, the backward is
taken view by view: both backbone passes first without a graph, then the
heads' backward from those features, then each view's backbone again with
its graph, back-propagating the features' gradient; the BatchNorm buffers
are restored after the second pass, so they move once per view, as in one
pass. Train-mode BatchNorm normalises with the batch's statistics, so the
second pass repeats the first.

Returns, per step, the loss; for the first step, its answers (view 0's
gaze of the last iteration, per row) and each leaf's gradient norm as the
moments took it; after the last, each leaf's change norm.
``low_precision`` ("int8", "fp8") makes it the control
(``model.set_low_precision``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from perfbench.reference import model as reference
from perfbench.reference import ops


def train_readings(config: Dict[str, Any], traffic: Dict[str, Any], state: Dict[str, torch.Tensor],
                   batches: List[Dict[str, torch.Tensor]], aug_seed: int, low_precision: Optional[str] = None
                   ) -> Dict[str, Any]:
    device = batches[0]["img_0"].device
    net = reference.build_on(config, device, state)
    reference.set_low_precision(net, low_precision)
    net.train()
    params = dict(net.named_parameters())
    opt_cfg, loss_cfg, sched = traffic["optimizer"], config["loss"], traffic["schedule"]
    opt = ops.Adam(params, tuple(opt_cfg["betas"]), opt_cfg["eps"], opt_cfg["weight_decay"])
    lr = ops.triangular2(sched["base_lr"], sched["max_lr"], sched["step_size_up"], sched["step_size_down"])
    start = {n: p.detach().clone() for n, p in params.items()}
    backbone = net.backbone
    losses, grad_norm = [], {}
    with reference.exact_float32():
        for t, batch in enumerate(batches):
            g = torch.Generator(device=device).manual_seed(ops.fold_seed(aug_seed, t))
            views = [ops.augment(batch["img_0"], g), ops.augment(batch["img_1"], g)]
            rots = [ops.rotation(batch["head_pose_0"]), ops.rotation(batch["head_pose_1"])]
            for p in params.values():
                p.grad = None
            with torch.no_grad():
                feats = [backbone(x).requires_grad_() for x in views]
            moved = {n: b.clone() for n, b in net.named_buffers()}
            gazes = net.heads(feats[0], feats[1], rots[0], rots[1])
            loss = ops.stereo_loss(gazes, batch["gt_gaze"], batch["gt_gaze_1"], loss_cfg["rel_weight"],
                                   loss_cfg["iter_decay"])
            loss.backward()
            for x, f in zip(views, feats):
                backbone(x).backward(f.grad)
            with torch.no_grad():
                for n, b in net.named_buffers():
                    b.copy_(moved[n])
            taken = opt.step(lr(t))
            losses.append(loss.detach())
            if t == 0:
                first_pred = gazes[-1][0].detach().cpu().numpy()
                names = list(taken)
                norms = torch.stack([taken[n].norm() for n in names]).tolist()
                grad_norm = dict(zip(names, norms))
            del views, feats, gazes, loss
        names = list(grad_norm)
        change = torch.stack([(params[n].detach() - start[n]).norm() for n in names]).tolist()
    return {"loss": torch.stack(losses).tolist(), "grad_norm": grad_norm,
            "change_norm": dict(zip(names, change)), "pred_first": first_pred}


@torch.no_grad()
def serve_answers(config: Dict[str, Any], state: Dict[str, torch.Tensor], frames: Dict[str, torch.Tensor],
                  block: int = 64) -> torch.Tensor:
    """The V-view reference's eval-mode answer (N, 2) for every frame,
    ``block`` frames at a time."""
    device = frames["imgs"].device
    net = reference.build_on(config, device, state)
    net.eval()
    out = []
    with reference.exact_float32():
        for i in range(0, frames["imgs"].shape[0], block):
            imgs = frames["imgs"][i:i + block]
            poses = frames["head_poses"][i:i + block]
            out.append(net(ops.eval_images(imgs), ops.rotation(poses)))
    return torch.cat(out)
