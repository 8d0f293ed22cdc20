"""Carry a JAX-package param tree over to the port.

`params_from_jax(tree, device)` takes a JAX-package param tree of any
family with its leaves already turned into numpy arrays (e.g.
`jax.tree.map(np.asarray, model.init(key))` where JAX is present) and
returns the same tree of torch tensors on `device`:

  dcn / dcn_v2  embedding, cross[{w,b}], mlp[{w,b}], out{w,b}
  wide_deep     wide [V], wide_bias (0-d), embedding, mlp[{w,b}], out{w,b}
  deepfm        linear [V], bias (0-d), embedding, mlp[{w,b}], out{w,b}
  generic       embedding, mlp[{w,b}], out{w,b}
  two_tower     embedding, user_mlp[{w,b}], item_mlp[{w,b}], temperature (0-d)
  dlrm          embedding, bottom_mlp[{w,b}], top_mlp[{w,b}], out{w,b}

and the int8 {qw, qscale, b} form of any dense layer. Names, layouts
([in, out] weights) and ranks are unchanged (a 0-d leaf stays 0-d), so both
packages compute the same function. This module itself imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    """Recursively convert dicts/lists/tuples of numpy arrays to tensors on
    `device`, keeping each leaf's dtype."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    # A copy: leaves converted from JAX arrays are read-only views.
    return torch.from_numpy(np.array(tree, copy=True, order="C")).to(device)
