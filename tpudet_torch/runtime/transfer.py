"""Weight transfer from tpudet's flax variables to the port's ``state_dict``.

``from_flax(variables)`` takes the ``{"params", "batch_stats"}`` tree (nested
dicts of numpy arrays, as ``jax.device_get`` returns them) and renames each
leaf by the port's module names, which are flax's:

  * ``.../conv/kernel`` (HWIO) -> ``....conv.weight`` (OIHW); ``.../conv/bias``;
  * ``.../dconv/kernel`` (HWIO of flax's ``ConvTranspose``) -> ``....dconv.weight``
    (``[in, out, kh, kw]``, flipped in both spatial axes: flax does not flip
    the kernel, torch's ``conv_transpose2d`` does); ``.../dconv/bias``;
  * ``.../bn/{scale,bias}`` and ``batch_stats/.../bn/{mean,var}`` keep their
    names (see :class:`tpudet_torch.nn.layers.BatchNorm`), as do the
    GroupNorms' ``.../gn/{scale,bias}`` and the GroupNorm ResNet's stem,
    ``init_conv/{kernel,bias}`` (a bare conv) and ``init_gn/{scale,bias}``;
  * the L2-norm ``scale`` of shape ``[1]`` (``l2_norm``, and RefineDet's and
    PFPNet's ``feat1_l2_norm`` and ``feat2_l2_norm``);
  * LH-RCNN's bias-free ``.../depthwise/kernel`` (HWIO ``[kh, kw, 1, C]`` ->
    ``[C, 1, kh, kw]``) and ``.../pointwise/kernel``, converted as conv
    kernels, and its RoI head's dense ``roi_feat_dense``, ``rcnn_pconf`` and
    ``rcnn_pbbox`` (``kernel [in, out]`` -> ``weight [out, in]``; ``bias``).

A leaf of any other form raises. :func:`load_flax` then loads strictly, so a
missing or extra key, or a shape that differs, raises too.
:func:`opt_state_from_flax` renames tpudet's optimizer state (Momentum's
``velocity``, Adam's ``count``, ``mu`` and ``nu``) the same way, and
:func:`subtree` cuts one module's entries out of a ``state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAVES = {
    ("params", "conv", "kernel"),
    ("params", "conv", "bias"),
    ("params", "bn", "scale"),
    ("params", "bn", "bias"),
    ("batch_stats", "bn", "mean"),
    ("batch_stats", "bn", "var"),
    ("params", "dconv", "kernel"),
    ("params", "dconv", "bias"),
    ("params", "l2_norm", "scale"),
    ("params", "feat1_l2_norm", "scale"),
    ("params", "feat2_l2_norm", "scale"),
    ("params", "gn", "scale"),
    ("params", "gn", "bias"),
    ("params", "init_conv", "kernel"),
    ("params", "init_conv", "bias"),
    ("params", "init_gn", "scale"),
    ("params", "init_gn", "bias"),
    ("params", "depthwise", "kernel"),
    ("params", "pointwise", "kernel"),
    ("params", "roi_feat_dense", "kernel"),
    ("params", "roi_feat_dense", "bias"),
    ("params", "rcnn_pconf", "kernel"),
    ("params", "rcnn_pconf", "bias"),
    ("params", "rcnn_pbbox", "kernel"),
    ("params", "rcnn_pbbox", "bias"),
}


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree -> the port's ``state_dict``."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unexpected flax collections {sorted(extra)}")
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(collection, {})):
            kind = (collection,) + tuple(path[-2:])
            if kind not in _LEAVES:
                raise KeyError(f"no port counterpart for flax leaf "
                               f"{collection}/{'/'.join(path)}")
            if isinstance(leaf, torch.Tensor):  # a bfloat16 leaf of a .tpudet file
                leaf = leaf.float().numpy()
            arr = np.asarray(leaf, np.float32)
            name = ".".join(path)
            if path[-1] == "kernel":
                if arr.ndim == 2:  # a dense kernel
                    arr = arr.T
                elif path[-2] == "dconv":
                    arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]  # IOHW, flipped
                else:
                    arr = arr.transpose(3, 2, 0, 1)  # OIHW
                name = ".".join(path[:-1] + ("weight",))
            if name in out:
                raise KeyError(f"flax leaf {name} appears twice")
            out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


def load_flax(module: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy flax variables into ``module``; raises on any missing or extra key."""
    module.load_state_dict(from_flax(variables), strict=True)


def velocity_from_flax(velocity: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """tpudet's Momentum state (``opt_state.velocity``: the tree of ``params``,
    as numpy arrays) -> the port's velocity dict, keyed like
    ``named_parameters()``; kernels convert as the parameters do."""
    return from_flax({"params": velocity})


def opt_state_from_flax(opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """tpudet's optimizer state, as its checkpoints hold it -> the port's:
    Momentum's ``{"velocity": tree}`` or Adam's ``{"count": scalar, "mu":
    tree, "nu": tree}``, each tree of ``params`` renamed by
    :func:`velocity_from_flax` and ``count`` an int32 tensor."""
    if set(opt_state) == {"velocity"}:
        return {"velocity": velocity_from_flax(opt_state["velocity"])}
    if set(opt_state) == {"count", "mu", "nu"}:
        return {"count": torch.tensor(np.asarray(opt_state["count"]), dtype=torch.int32),
                "mu": velocity_from_flax(opt_state["mu"]),
                "nu": velocity_from_flax(opt_state["nu"])}
    raise KeyError(f"unknown optimizer state with keys {sorted(opt_state)}")


def subtree(state: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``state`` under the module ``prefix`` (dotted), with the
    prefix cut off; raises if there are none."""
    head = prefix + "."
    out = {k[len(head):]: v for k, v in state.items() if k.startswith(head)}
    if not out:
        raise KeyError(f"no entries under {prefix!r}")
    return out
