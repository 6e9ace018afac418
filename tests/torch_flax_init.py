"""tpudet's initial weights for the port, and the way back.

``python tests/torch_flax_init.py [NAME]`` writes flax's own initial variables
of tpudet's convergence spec ``NAME`` (``scripts/train_convergence.py``;
default PFPNetR) as the port's ``state_dict``, renamed by
``transfer.from_flax``, to ``init_path(NAME)`` of
``scripts/convergence_variants_torch.py``: ``build/<NAME>_tpudet_init.pt``
(PFPNetR's: ``build/pfpnet_tpudet_init.pt``, ~211 MB; CenterNet's ~107 MiB),
for the variant ``NAME-tpudet-init`` there.

tpudet's model initialises as it does in a run (``net.init`` with
``PRNGKey(seed)``, seed 0, on a zero image of the spec's input);
``jax.random`` gives the same values on any backend. It needs JAX and tpudet
(~35 s on the CPU for PFPNetR) and prints the tensors' count, the
parameters' count and ``weight_decay * global_l2`` of the result.

:func:`to_flax` is ``from_flax``'s inverse: a port ``state_dict`` (a carry
copy, say) back into tpudet's ``{"params", "batch_stats"}`` tree.
"""

import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
# the spec keys only the convergence scripts read
SCRIPT_KEYS = ("gt_pad", "host_feed", "chunk_bytes", "rotate_every", "max_bytes")


def _paths():
    for p in (str(REPO / "scripts"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)


def spec_class(name, size=None, mode="test"):
    """tpudet's model class of spec ``name`` and its config without the
    script-only keys, in ``mode``; ``size`` an input ``(h, w)`` other than
    the spec's (the class's ``input_size``, the config's ``input_size`` and
    ``data_shape``)."""
    _paths()
    import train_convergence as tpudet_script

    cls_path, _, config, _, _, _ = tpudet_script.model_specs()[name]
    cls = tpudet_script._load_class(cls_path)
    config = {k: v for k, v in config.items() if k not in SCRIPT_KEYS}
    if size is not None:
        h, w = size
        cls = type(cls.__name__, (cls,), {"input_size": h})
        if "input_size" in config:
            config["input_size"] = h
        if "data_shape" in config:
            config["data_shape"] = [h, w, 3]
    return cls, dict(config, mode=mode)


def tpudet_model(name, size=None, mode="test"):
    """tpudet's model of spec ``name`` (:func:`spec_class`), initialised as
    in a run, and its config."""
    cls, config = spec_class(name, size, mode)
    return cls(config), config


def flax_init_state(name, size=None):
    """flax's initial variables of spec ``name`` as the port's ``state_dict``,
    and tpudet's ``weight_decay * global_l2`` of its parameters."""
    import jax

    from tpudet.models.base import global_l2
    from tpudet_torch.runtime import transfer

    model, config = tpudet_model(name, size)
    state = transfer.from_flax({"params": jax.device_get(model.params),
                                "batch_stats": jax.device_get(model.batch_stats)})
    return state, config["weight_decay"] * float(global_l2(model.params))


def to_flax(state_dict, template):
    """The port's ``state_dict`` as tpudet's ``{"params", "batch_stats"}``
    tree on ``template`` (tpudet's variables, nested dicts): each leaf
    renamed as ``transfer.from_flax`` does and its transpose undone (dense
    ``.T``; ``dconv``: flipped back, then IOHW -> HWIO; other kernels: OIHW
    -> HWIO), float32 numpy of the template leaf's shape. A key of
    ``state_dict`` that the template lacks, or the reverse, raises."""
    used = set()

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):  # a dict or flax's FrozenDict
                out[k] = walk(v, path + (k,))
                continue
            p = path + (k,)
            name = ".".join(p[1:-1] + ("weight" if k == "kernel" else k,))
            arr = state_dict[name].detach().float().cpu().numpy()
            if k == "kernel":
                if arr.ndim == 2:
                    arr = arr.T
                elif p[-2] == "dconv":
                    arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    arr = arr.transpose(2, 3, 1, 0)
            if arr.shape != tuple(np.shape(v)):
                raise ValueError(f"{name}: {arr.shape} against {np.shape(v)}")
            used.add(name)
            out[k] = np.ascontiguousarray(arr, np.float32)
        return out

    tree = {c: walk(template.get(c, {}), (c,)) for c in ("params", "batch_stats")}
    extra = set(state_dict) - used
    if extra:
        raise KeyError(f"no flax leaf for {sorted(extra)}")
    return tree


def main(argv, size=None, out=None):
    """Write spec ``argv[0]``'s file (default PFPNetR) to ``out`` (default
    ``init_path``), at an input ``size`` other than the spec's if given."""
    import torch

    _paths()
    from convergence_variants_torch import init_path

    name = argv[0] if argv else "PFPNetR"
    state, wd_l2 = flax_init_state(name, size)
    out = out or init_path(name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save(state, out)
    n = sum(v.numel() for k, v in state.items() if not k.endswith((".mean", ".var")))
    print(f"{out}: {len(state)} tensors, {n} parameters, "
          f"weight_decay * global_l2 = {wd_l2:.5f}")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:])
