"""The supervised train state (``tpuwsi/train/state.py``): the step, the
model, the optimizer's state, the EMA copy and the generator the step draws
from."""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from tpuwsi_torch.train.optim import load_opt_state, opt_state_dict


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: object
    # the EMA copy of ``model`` (timm ModelEmaV2), None without --model-ema
    ema: Optional[nn.Module] = None
    generator: Optional[torch.Generator] = None

    def state_dict(self) -> dict:
        """Everything a restore needs to continue bit for bit: the step, the
        parameters, the optimizer's count and tensors (in the order of the
        parameters it updates), the EMA copy's parameters and the generator's
        state. The tensors are the state's own (``torch.save`` copies them)."""
        out = {"step": int(self.step), "params": self.model.state_dict(),
               "opt_state": opt_state_dict(self.opt_state)}
        if self.ema is not None:
            out["ema_params"] = self.ema.state_dict()
        if self.generator is not None:
            out["generator"] = self.generator.get_state()
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict, opt_state: bool = True) -> None:
        """Copy a ``state_dict()`` into this state in place (parameters and
        optimizer tensors keep their storage, so the step built for them
        stays valid); ``opt_state`` False leaves the optimizer's state as it
        is (--no-resume-opt)."""
        self.model.load_state_dict(sd["params"])
        if opt_state:
            load_opt_state(self.opt_state, sd["opt_state"])
        if self.ema is not None:
            if "ema_params" not in sd:
                raise ValueError("this state has an EMA copy and the checkpoint holds none")
            self.ema.load_state_dict(sd["ema_params"])
        self.step = int(sd["step"])
        if "generator" in sd:
            if self.generator is None:
                raise ValueError("the checkpoint holds a generator state and this state has "
                                 "no generator")
            self.generator.set_state(sd["generator"].cpu())


def create_train_state(model: nn.Module, optimizer, ema: bool = False,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """The optimizer's state over the parameters that take gradients; with
    ``ema`` a copy of ``model`` that takes none."""
    params = [p for p in model.parameters() if p.requires_grad]
    return TrainState(
        step=0, model=model, opt_state=optimizer.init(params),
        ema=copy.deepcopy(model).requires_grad_(False).eval() if ema else None,
        generator=generator)
