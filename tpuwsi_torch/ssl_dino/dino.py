"""DINO student/teacher self-supervised training (``tpuwsi/ssl_dino/dino.py``).

The student sees all views, the EMA teacher the global ones; the loss is the
cross-entropy between the centred, sharpened teacher and the student over
every pair of different views. The state lives on the device and is updated
in place: student parameters by the optimizer, teacher parameters by the
EMA, the centre by its own moving average.

Randomness of a step comes from one ``torch.Generator`` on the step's device,
in this order: multi-crop (when the step makes its own views), then the
student's forward on the global views, then its forward on the local views
(each as ``VisionTransformer`` documents). The teacher's forward is
deterministic.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from tpuwsi_torch.models.dino_head import DINOHead
from tpuwsi_torch.models.vit import VisionTransformer
from tpuwsi_torch.train.ema import cosine_momentum_schedule, ema_update


class DINOModel(nn.Module):
    """ViT backbone + DINO projection head (student and teacher geometry)."""

    def __init__(self, backbone: VisionTransformer, head: DINOHead):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x, deterministic: bool = True, generator=None):
        feats = self.backbone(x, deterministic, generator)
        return self.head(feats, deterministic)


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    out_dim: int = 65536
    n_global: int = 2
    n_local: int = 6
    student_temp: float = 0.1
    teacher_temp: float = 0.04
    warmup_teacher_temp: float = 0.04
    warmup_teacher_temp_steps: int = 0
    center_momentum: float = 0.9
    ema_base: float = 0.996
    ema_final: float = 1.0
    total_steps: int = 100_000
    freeze_last_layer_steps: int = 0
    # run the (B, out_dim) cross-view contractions on bf16 operands (fp32 sums)
    loss_pair_bf16: bool = False


@dataclasses.dataclass
class DINOState:
    step: int
    student: DINOModel
    teacher: DINOModel
    opt_state: object
    center: torch.Tensor  # (1, out_dim) fp32
    # the generator the step draws from, when the state carries it
    generator: Optional[torch.Generator] = None

    def state_dict(self) -> dict:
        """Everything a restore needs to continue bit for bit: the step, the
        student and teacher parameters, AdamW's count, mu and nu (in
        ``student.parameters()`` order), the centre and the generator's state.
        The tensors are the state's own (``torch.save`` copies them)."""
        out = {"step": int(self.step), "student": self.student.state_dict(),
               "teacher": self.teacher.state_dict(),
               "opt_state": {"count": int(self.opt_state.count),
                             "mu": list(self.opt_state.mu), "nu": list(self.opt_state.nu)},
               "center": self.center}
        if self.generator is not None:
            out["generator"] = self.generator.get_state()
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a ``state_dict()`` into this state in place (the parameters
        and moments keep their storage, so the step and optimizer built for
        them stay valid)."""
        self.student.load_state_dict(sd["student"])
        self.teacher.load_state_dict(sd["teacher"])
        opt = sd["opt_state"]
        for dst, key in ((self.opt_state.mu, "mu"), (self.opt_state.nu, "nu")):
            if len(dst) != len(opt[key]):
                raise ValueError(f"{key}: {len(opt[key])} tensors saved, {len(dst)} here")
            for d, s in zip(dst, opt[key]):
                if d.shape != s.shape:
                    raise ValueError(f"{key}: a saved {tuple(s.shape)} for {tuple(d.shape)}")
                d.copy_(s)
        if self.center.shape != sd["center"].shape:
            raise ValueError(f"center: saved {tuple(sd['center'].shape)}, "
                             f"here {tuple(self.center.shape)}")
        self.opt_state.count = int(opt["count"])
        self.center.copy_(sd["center"])
        self.step = int(sd["step"])
        if "generator" in sd:
            if self.generator is None:
                raise ValueError("the checkpoint holds a generator state and this state has "
                                 "no generator")
            self.generator.set_state(sd["generator"].cpu())


def create_dino_state(student: DINOModel, optimizer, cfg: DINOConfig,
                      generator: Optional[torch.Generator] = None) -> DINOState:
    """The teacher starts as a copy of the student and takes no gradients."""
    teacher = copy.deepcopy(student).requires_grad_(False)
    device = next(student.parameters()).device
    return DINOState(
        step=0, student=student, teacher=teacher,
        opt_state=optimizer.init(list(student.parameters())),
        center=torch.zeros((1, cfg.out_dim), dtype=torch.float32, device=device),
        generator=generator)


def teacher_temp_schedule(cfg: DINOConfig):
    def sched(step: int) -> float:
        t = min(max(step / max(cfg.warmup_teacher_temp_steps, 1), 0.0), 1.0)
        return cfg.warmup_teacher_temp + t * (cfg.teacher_temp - cfg.warmup_teacher_temp)

    return sched


def dino_loss(student_out, teacher_out, center, student_temp: float, teacher_temp: float,
              n_global: int, pair_dtype: torch.dtype = torch.float32):
    """Cross-entropy between teacher (centred, sharpened, detached) and
    student views, skipping same-view pairs → ``(loss, batch_center)``.

    student_out ``(n_views, B, K)``, teacher_out ``(n_global, B, K)``, center
    ``(1, K)``. The softmax and log-softmax are fp32; the per-pair
    contraction takes its operands in ``pair_dtype`` and sums in fp32. The
    batch centre is the mean over all rows of the uncentred teacher output.
    """
    t_probs = torch.softmax((teacher_out - center) / teacher_temp, dim=-1).detach()
    s_logp = torch.log_softmax(student_out / student_temp, dim=-1)
    t_pair = t_probs.to(pair_dtype).float()
    s_pair = s_logp.to(pair_dtype).float()
    total, count = 0.0, 0
    for ti in range(n_global):
        for si in range(s_logp.shape[0]):
            if si == ti:
                continue  # same global view: skip (DINO rule)
            total = total - (t_pair[ti] * s_pair[si]).sum(dim=-1).mean()
            count += 1
    batch_center = teacher_out.reshape(-1, teacher_out.shape[-1]).mean(dim=0, keepdim=True)
    return total / count, batch_center.detach()


def make_dino_train_step(model: DINOModel, optimizer, cfg: DINOConfig,
                         multicrop_fn: Optional[Callable] = None):
    """Returns ``step(state, batch, generator=None) → (state, metrics)``.

    ``model`` is the student, the module ``state.student`` refers to.
    ``batch["images"]`` is raw uint8 tiles (B, H, W, 3) when ``multicrop_fn``
    (``fn(generator, images) → (globals, locals)``) is given, else the batch
    holds pre-made ``"globals"`` (B, 2, Sg, Sg, 3) and ``"locals"``.
    ``state`` is updated in place and returned; metrics are a loss tensor (no
    host sync) and three floats.
    """
    ema_sched = cosine_momentum_schedule(cfg.ema_base, cfg.ema_final, cfg.total_steps)
    temp_sched = teacher_temp_schedule(cfg)
    pair_dtype = torch.bfloat16 if cfg.loss_pair_bf16 else torch.float32
    params = list(model.parameters())
    last_layer = [i for i, p in enumerate(params)
                  if any(p is q for q in model.head.last_layer.parameters())]

    def step(state: DINOState, batch, generator=None):
        if state.student is not model:
            raise ValueError("the step was built for another student module")
        if multicrop_fn is not None:
            with torch.no_grad():
                g_views, l_views = multicrop_fn(generator, batch["images"])
        else:
            g_views, l_views = batch["globals"], batch["locals"]
        b, vg = g_views.shape[0], g_views.shape[1]
        vl = l_views.shape[1]
        # (B, V, S, S, 3) → (V * B, S, S, 3): views of one kind share a forward
        g_flat = g_views.transpose(0, 1).reshape((-1,) + g_views.shape[2:])
        l_flat = l_views.transpose(0, 1).reshape((-1,) + l_views.shape[2:])
        t_temp = temp_sched(state.step)
        momentum = ema_sched(state.step)

        s_g = model(g_flat, deterministic=False, generator=generator).reshape(vg, b, -1)
        s_l = model(l_flat, deterministic=False, generator=generator).reshape(vl, b, -1)
        s_out = torch.cat([s_g, s_l], dim=0)
        with torch.no_grad():
            t_out = state.teacher(g_flat, deterministic=True).reshape(vg, b, -1)
        loss, batch_center = dino_loss(
            s_out.float(), t_out.float(), state.center, cfg.student_temp, t_temp,
            cfg.n_global, pair_dtype=pair_dtype)
        grads = list(torch.autograd.grad(loss, params, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        if state.step < cfg.freeze_last_layer_steps:
            # DINO trick: cancel last-layer gradients for the first steps,
            # before the clip, so the clip's norm leaves them out
            for i in last_layer:
                grads[i].zero_()
        grad_norm = optimizer.step(params, grads, state.opt_state)
        ema_update(state.teacher.parameters(), params, momentum)
        state.center = (state.center * cfg.center_momentum
                        + batch_center * (1.0 - cfg.center_momentum))
        state.step += 1
        metrics = {"loss": loss.detach(), "teacher_temp": t_temp, "ema_momentum": momentum,
                   "grad_norm": grad_norm}
        return state, metrics

    return step
