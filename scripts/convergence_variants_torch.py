"""One-off variants of ``scripts/train_convergence_torch.py``'s specs, for
probing a gap to tpudet's mAP without new flags on the script (tpudet's
script has none):

  * ``SPEC-seed1``: the spec with ``config["seed"] = 1`` (other initial
    weights and augmentation key; the feed's order is the spec's);
  * ``PFPNetR-fp32-2000``: PFPNetR in float32, the spec's first 2000 steps
    (its 250 warm-up steps at 0.1x, then 1750 at the base lr);
  * ``SPEC-tpudet-init``: the spec from flax's own initial variables of
    tpudet's spec (:func:`init_path`, written by ``python
    tests/torch_flax_init.py SPEC``), appending ``weight_decay * global_l2``
    after each chunk to ``wd_l2.jsonl`` in the run's directory; at its end
    the run's carry copy (below) is written;
  * ``LHRCNN-long-tpudet-init-rpn32``: ``LHRCNN-long-tpudet-init`` with its
    first RPN phase (steps before ``rpn_first_step``) in float32 with TF32
    off for convolutions and matrix products, then bfloat16 with PyTorch's
    default TF32 settings from ``rpn_first_step`` on (:func:`rpn_in_float32`).

A carry copy is a trained net small enough to bring back from the card:
:func:`carry_state` of the final checkpoint's ``state_dict``, written to
``carry.pt`` in the run's directory at the end of every ``*-tpudet-init``
run, and of every run named with ``--carry``. In a bfloat16 run every
kernel is cast to bfloat16 (round to nearest even) before it is used, so
the copy computes bit for bit what the trained net computes.

``--state-at=STEP`` ends an LH-RCNN ``*-tpudet-init`` run after STEP steps,
before the next (the script's chunks need not end there), having written
``state_at_STEP.pt`` to the run's directory: what the RPN phase trains
(:func:`phase_state`), which ``tests/torch_lhrcnn_teacher.py --state=``
(on the CPU) and ``scripts/lhrcnn_rcnn_probe_torch.py`` (on the card) step
the RCNN phase from. The run's steps to there are the full run's: the
schedule is the spec's, not scaled.

Usage (from the root of a checkout, on the card):
  python scripts/convergence_variants_torch.py NAME [--eval-every=N ...] [--carry]
      [--state-at=STEP]
The records go under ``.convergence/torch_runs/NAME/``, as the script's.
"""

import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch  # noqa: E402

import train_convergence_torch as tc  # noqa: E402
from tpudet_torch.models.base import global_l2  # noqa: E402
from tpudet_torch.runtime import checkpoint as ckpt  # noqa: E402

INIT_SUFFIX = "-tpudet-init"
RPN32_SUFFIX = "-rpn32"
CARRY = "carry.pt"
STATE_AT = {"step": None}  # --state-at's step


class StateWritten(BaseException):
    """Ends a run at ``--state-at``'s step once its state is written (not an
    ``Exception``: the script's queue records those as failed runs)."""


def phase_state(model):
    """LH-RCNN's RPN-phase state: the ``feature_extractor`` and ``rpn``
    parameters and their velocity, every BatchNorm statistic (float32, on
    the host) and ``global_step``."""
    from tpudet_torch.models.lhrcnn import RPN_SCOPES

    def trained(k):
        return k.split(".", 1)[0] in RPN_SCOPES

    state = model.net.state_dict()
    return {"global_step": model.global_step,
            "params": {k: v.detach().float().cpu() for k, v in state.items()
                       if trained(k) or k.endswith((".mean", ".var"))},
            "velocity": {k: v.detach().float().cpu() for k, v in model.velocity.items()
                         if trained(k)}}


def init_path(spec: str) -> str:
    """``build/<spec>_tpudet_init.pt`` (PFPNetR's keeps its first name,
    ``build/pfpnet_tpudet_init.pt``)."""
    stem = "pfpnet" if spec == "PFPNetR" else spec
    return os.path.join(tc.ROOT, "build", f"{stem}_tpudet_init.pt")


def carry_state(state_dict):
    """``state_dict`` with every floating leaf of two or more dimensions
    (conv and dense kernels) rounded to bfloat16; the 1-D leaves (biases,
    BatchNorm's scale, bias and statistics) stay float32."""
    return {k: v.detach().to(torch.bfloat16)
            if v.is_floating_point() and v.dim() >= 2 else v.detach()
            for k, v in state_dict.items()}


def write_carry(name: str, root: str = tc.CONVERGENCE_ROOT) -> str:
    """The carry copy of run ``name``'s newest checkpoint, to its directory."""
    run_dir = os.path.join(root, "torch_runs", name)
    blob = ckpt.load_state(ckpt.resolve(os.path.join(run_dir, "ckpt")))
    out = os.path.join(run_dir, CARRY)
    torch.save(carry_state(blob["state_dict"]), out)
    print(f"[{name}] carry copy of step {blob['global_step']}: {out} "
          f"({os.path.getsize(out) / 2**20:.1f} MiB)", flush=True)
    return out


@functools.lru_cache(maxsize=None)
def from_tpudet_init(spec: str, run: str | None = None):
    """The class of ``spec`` whose initial parameters and statistics are
    :func:`init_path`'s, loaded strictly, and whose epochs log
    ``weight_decay * global_l2`` into run ``run``'s directory (default
    ``spec`` + ``-tpudet-init``)."""
    base = tc._load_class(_base_specs()[spec][0])
    run = run or spec + INIT_SUFFIX

    def __init__(self, *args, **kwargs):
        base.__init__(self, *args, **kwargs)
        state = torch.load(init_path(spec), map_location=self.device)
        self.net.load_state_dict(state, strict=True)
        self.l2_log = os.path.join(tc.CONVERGENCE_ROOT, "torch_runs", run, "wd_l2.jsonl")

    def train_one_epoch(self, lr, writer=None):
        out = base.train_one_epoch(self, lr, writer)
        with torch.no_grad():
            term = self.weight_decay * float(global_l2(self.net.parameters()))
        os.makedirs(os.path.dirname(self.l2_log), exist_ok=True)
        with open(self.l2_log, "a") as f:
            f.write(json.dumps({"step": self.global_step, "wd_l2": round(term, 5),
                                "mean_loss": round(float(out), 5)}) + "\n")
        return out

    def train_step(self, images, gt, lr):
        # before the step: the state after STEP steps, whatever the chunks
        if self.global_step == STATE_AT["step"]:
            path = os.path.join(os.path.dirname(self.l2_log),
                                f"state_at_{self.global_step}.pt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(phase_state(self), path)
            print(f"\n[{run}] state at step {self.global_step}: {path} "
                  f"({os.path.getsize(path) / 2**20:.1f} MiB)", flush=True)
            raise StateWritten(path)
        return base.train_step(self, images, gt, lr)

    return type(base.__name__ + "FromTpudetInit", (base,),
                {"__init__": __init__, "train_one_epoch": train_one_epoch,
                 "train_step": train_step, "__module__": __name__})


def set_compute_dtype(model, dtype, conv_tf32: bool):
    """Every module's ``compute_dtype`` (the model's too) to ``dtype``, TF32
    for cuDNN convolutions to ``conv_tf32`` and for matrix products off
    (PyTorch's default). The parameters stay float32: each layer casts its
    kernel when it runs."""
    model.compute_dtype = dtype
    for module in model.net.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = dtype
    torch.backends.cudnn.allow_tf32 = conv_tf32
    torch.backends.cuda.matmul.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def rpn_in_float32(spec: str):
    """``spec``'s ``-tpudet-init`` class, built in float32 with TF32 off; at
    ``rpn_first_step`` it turns to bfloat16 with PyTorch's defaults (TF32
    convolutions, float32 matrix products), as the spec's own run has."""
    run = spec + INIT_SUFFIX + RPN32_SUFFIX
    base = from_tpudet_init(spec, run)

    def __init__(self, *args, **kwargs):
        base.__init__(self, *args, **kwargs)
        set_compute_dtype(self, torch.float32, conv_tf32=False)

    def train_step(self, images, gt, lr):
        if self.global_step >= self.rpn_first_step and self.compute_dtype != torch.bfloat16:
            set_compute_dtype(self, torch.bfloat16, conv_tf32=True)
            print(f"\n[{run}] step {self.global_step}: bfloat16 from here", flush=True)
        return base.train_step(self, images, gt, lr)

    return type(base.__name__ + "Rpn32", (base,),
                {"__init__": __init__, "train_step": train_step, "__module__": __name__})


def __getattr__(attr):
    # the spec's class path of a variant: "<module>.<SPEC>-tpudet-init[-rpn32]"
    if attr.endswith(INIT_SUFFIX + RPN32_SUFFIX):
        return rpn_in_float32(attr[:-len(INIT_SUFFIX + RPN32_SUFFIX)])
    if attr.endswith(INIT_SUFFIX):
        return from_tpudet_init(attr[:-len(INIT_SUFFIX)])
    raise AttributeError(attr)


_base_specs = tc.model_specs


def model_specs():
    """The script's specs and the variants of the module docstring."""
    specs = _base_specs()
    for name in list(specs):
        cls, size, config, lr, steps, schedule = specs[name]
        specs[name + "-seed1"] = (cls, size, dict(config, seed=1), lr, steps, schedule)
        specs[name + INIT_SUFFIX] = (f"{__name__}.{name}{INIT_SUFFIX}", size, config, lr,
                                     steps, schedule)
    cls, size, config, lr, steps, schedule = specs["LHRCNN-long"]
    name = "LHRCNN-long" + INIT_SUFFIX + RPN32_SUFFIX
    specs[name] = (f"{__name__}.{name}", size, config, lr, steps, schedule)
    cls, size, config, lr, steps, schedule = specs["PFPNetR"]
    specs["PFPNetR-fp32-2000"] = (cls, size, dict(config, compute_dtype="float32"), lr,
                                  2000, [(0.125, 0.1), (0.875, 1.0)])
    return specs


def main(argv):
    tc.model_specs = model_specs
    for a in argv:
        if a.startswith("--state-at="):
            STATE_AT["step"] = int(a.split("=", 1)[1])
    try:
        rc = tc.main(argv)
    except StateWritten:
        return 0
    names = [a for a in argv if not a.startswith("--")]
    for name in names:
        done = os.path.exists(os.path.join(tc.CONVERGENCE_ROOT, "torch_runs", name,
                                           "result.json"))
        if done and (name.endswith(INIT_SUFFIX) or "--carry" in argv):
            write_carry(name)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
