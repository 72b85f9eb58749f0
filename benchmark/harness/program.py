"""The system under test: the configuration's factory from the PyTorch
port, bound at the configuration's signature, and its compiled entries
(``make_scan`` and ``jit_step``, ``blocks/base.py``).  The benchmark
takes nothing else from the program but its kernel-launch counters."""

from __future__ import annotations

import importlib

import torch


class Program:
    def __init__(self, config: dict, device, batch: int = None):
        from radiorust_tpu_torch.blocks.base import StreamSig
        from radiorust_tpu_torch.convert import tree_to_torch
        mod_name, fn_name = config["factory"].rsplit(".", 1)
        spec = getattr(importlib.import_module(mod_name), fn_name)(
            **config["args"])
        s = config["sig"]
        sig = StreamSig(int(s["batch"] if batch is None else batch),
                        int(s["chunk_len"]), float(s["sample_rate"]))
        self.graph = hasattr(spec, "input")
        self.bound = spec.bind({"iq": sig} if self.graph else sig)
        self.outputs = list(config["outputs"])
        self.device = torch.device(device)
        self.params = tree_to_torch(self.bound.params, self.device)
        self.state0 = tree_to_torch(self.bound.init_state(), self.device)

    def make_scan(self):
        from radiorust_tpu_torch.blocks.base import make_scan
        return make_scan(self.bound)

    def jit_step(self):
        from radiorust_tpu_torch.blocks.base import jit_step
        return jit_step(self.bound)

    def feed(self, x: torch.Tensor):
        """The entry's input for chunks ``x``."""
        return {"iq": x} if self.graph else x

    def named(self, y) -> dict:
        """The entry's output as {output name: tensor}."""
        return dict(y) if self.graph else {self.outputs[0]: y}


def launch_counters() -> dict:
    """The port's kernel wrappers' ``launches`` counters (counted where a
    step is captured or runs eagerly, not on a replay)."""
    from radiorust_tpu_torch.ops import kernel_wrappers
    return {w.__name__: int(getattr(w, "launches", 0))
            for w in kernel_wrappers()}
