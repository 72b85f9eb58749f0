"""Move params and state trees between numpy and torch.

Bound blocks hold numpy params and numpy initial state, as the JAX
package's do.  :func:`tree_to_torch` turns such a tree (or the JAX
package's own params and state, through ``np.asarray`` of each leaf) into
tensors on one device; :func:`tree_to_numpy` turns the port's tensors
back into numpy arrays, for instance to hand a state to the JAX package.
The keys, shapes and dtypes stay as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from .numbers import check_device

__all__ = ["tree_to_torch", "tree_to_numpy"]


def _map(tree, leaf):
    if isinstance(tree, dict):
        return {k: _map(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf) for v in tree)
    return leaf(tree)


def tree_to_torch(tree, device):
    """Every array-like leaf (numpy array, numpy scalar, or any object
    ``np.asarray`` accepts) becomes a tensor on ``device``.  Every params
    and state tree reaches a device here, so this is where the c128
    stream mode refuses CUDA (``numbers.check_device``)."""
    check_device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.from_numpy(np.array(np.asarray(x))).to(device)
    return _map(tree, leaf)


def tree_to_numpy(tree):
    """Every tensor leaf becomes a numpy array (0-d for a scalar)."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    return _map(tree, leaf)
