"""The port stands alone: it imports and runs with jax blocked, no module
of it imports jax, and on CPU tensors no kernel is launched."""

import ast
import pathlib
import subprocess
import sys

import radiorust_tpu_torch

PKG = pathlib.Path(radiorust_tpu_torch.__file__).parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
import numpy as np
import torch
import radiorust_tpu_torch
from radiorust_tpu_torch import prelude  # noqa: F401
from radiorust_tpu_torch.blocks.base import StreamSig, scan
from radiorust_tpu_torch.blocks.graph import graph_scan
from radiorust_tpu_torch.convert import tree_to_torch
from radiorust_tpu_torch.models.channelizer import channelized_receiver
from radiorust_tpu_torch.models.stereo import wfm_stereo_receiver
from radiorust_tpu_torch.models.wfm import wfm_receiver
from radiorust_tpu_torch.ops import channelizer as och, filter as ofl
from radiorust_tpu_torch.ops import frontend as ofe

sig = StreamSig(2, 24576, 1024000.0)
b = wfm_receiver(tune_shift=100e3, fuse_frontend=True, fuse_demod=True,
                 filter_ir_len=6144).bind(sig)
params = tree_to_torch(b.params, "cpu")
state = tree_to_torch(b.init_state(), "cpu")
rng = np.random.default_rng(0)
xs = torch.from_numpy(np.exp(1j * rng.standard_normal((2, 2, 24576)))
                      .astype(np.complex64))
state, ys = scan(b, params, state, xs)
assert ys.shape == (2, 2, 1152) and bool(torch.isfinite(ys.real).all())
mid = wfm_receiver(fuse_mid=True, fuse_frontend=True,
                   filter_ir_len=6144).bind(sig)
_, ys = scan(mid, tree_to_torch(mid.params, "cpu"),
             tree_to_torch(mid.init_state(), "cpu"), xs)
assert ys.shape == (2, 2, 1152) and bool(torch.isfinite(ys.real).all())
g = wfm_stereo_receiver(fuse_frontend=True,
                        filter_ir_len=6144).bind({"iq": sig})
_, ys = graph_scan(g, tree_to_torch(g.params, "cpu"),
                   tree_to_torch(g.init_state(), "cpu"), {"iq": xs})
assert ys["stereo"].shape == (2, 2, 1152)
ch = channelized_receiver(fuse=True).bind(StreamSig(1, 4096, 16384000.0))
_, ys = scan(ch, tree_to_torch(ch.params, "cpu"),
             tree_to_torch(ch.init_state(), "cpu"), xs[:, :1, :4096])
assert ys.shape == (2, 64, 64) and bool(torch.isfinite(ys.real).all())
wrappers = [ofe.decimate, ofe.fused_mix_decimate, ofl.fused_overlap_save,
            ofl.fused_filter_bank, ofl.fused_demod_filter,
            ofl.fused_filter_demod_filter, och.fused_pfb_demod]
counts = [w.launches for w in wrappers]
assert counts == [0] * 7, counts
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
"""


def test_port_runs_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_no_module_of_the_port_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "radiorust_tpu"), (f, name)
