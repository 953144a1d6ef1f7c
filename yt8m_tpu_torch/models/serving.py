"""Serving constants computed once per model.

A serving model folds its BatchNorms into affines and casts its weights
to the compute dtype once, not on every call. The constants are dropped
when the parameters move (`.to`, `.cuda`), are reloaded
(`load_state_dict`) or the model changes mode (`train()`, `eval()`),
and rebuilt on the next call. Writing to a parameter in place does not
drop them: call `invalidate_serving()` (the port's optimizer step does).
A training forward never reads them: it reads the parameters, so that
autograd reaches them. A model holding a tensor-parallel block
(parallel/tensor.py) refuses to build them: serving reads whole
tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.parallel import tensor


class ServingModule(nn.Module):
    def __init__(self):
        super().__init__()
        self._serving = None

    def make_serving_constants(self) -> dict:
        raise NotImplementedError

    def serving_constants(self) -> dict:
        if self._serving is None:
            tensor.refuse_blocks(self)
            with torch.no_grad():
                self._serving = self.make_serving_constants()
        return self._serving

    def invalidate_serving(self) -> None:
        for mod in self.modules():
            if isinstance(mod, ServingModule):
                mod._serving = None

    def train(self, mode: bool = True):
        self.invalidate_serving()
        return super().train(mode)

    def _apply(self, fn, recurse=True):
        self._serving = None
        return super()._apply(fn, recurse)

    def load_state_dict(self, state_dict, strict=True, assign=False):
        self.invalidate_serving()
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)
