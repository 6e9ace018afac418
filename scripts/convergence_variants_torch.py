"""One-off variants of ``scripts/train_convergence_torch.py``'s specs, for
probing a gap to tpudet's mAP without new flags on the script (tpudet's
script has none):

  * ``SPEC-seed1``: the spec with ``config["seed"] = 1`` (other initial
    weights and augmentation key; the feed's order is the spec's);
  * ``PFPNetR-fp32-2000``: PFPNetR in float32, the spec's first 2000 steps
    (its 250 warm-up steps at 0.1x, then 1750 at the base lr);
  * ``PFPNetR-tpudet-init``: PFPNetR from flax's own initial variables of
    tpudet's spec (``INIT``, written by ``tests/torch_flax_init.py``),
    appending ``weight_decay * global_l2`` after each chunk to
    ``wd_l2.jsonl`` in the run's directory.

Usage (from the root of a checkout, on the card):
  python scripts/convergence_variants_torch.py NAME [--eval-every=N ...]
The records go under ``.convergence/torch_runs/NAME/``, as the script's.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch  # noqa: E402

import train_convergence_torch as tc  # noqa: E402
from tpudet_torch.models.base import global_l2  # noqa: E402
from tpudet_torch.models.refinedet import PFPNetR  # noqa: E402

INIT = os.path.join(tc.ROOT, "build", "pfpnet_tpudet_init.pt")


class PFPNetRFromTpudetInit(PFPNetR):
    """PFPNetR whose initial parameters and statistics are ``INIT``'s."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.net.load_state_dict(torch.load(INIT, map_location=self.device))
        self.l2_log = os.path.join(tc.CONVERGENCE_ROOT, "torch_runs", "PFPNetR-tpudet-init",
                                   "wd_l2.jsonl")

    def train_one_epoch(self, lr, writer=None):
        out = super().train_one_epoch(lr, writer)
        with torch.no_grad():
            term = self.weight_decay * float(global_l2(self.net.parameters()))
        with open(self.l2_log, "a") as f:
            f.write(json.dumps({"step": self.global_step, "wd_l2": round(term, 5),
                                "mean_loss": round(float(out), 5)}) + "\n")
        return out


_base_specs = tc.model_specs


def model_specs():
    """The script's specs and the variants of the module docstring."""
    specs = _base_specs()
    for name in list(specs):
        cls, size, config, lr, steps, schedule = specs[name]
        specs[name + "-seed1"] = (cls, size, dict(config, seed=1), lr, steps, schedule)
    cls, size, config, lr, steps, schedule = specs["PFPNetR"]
    specs["PFPNetR-fp32-2000"] = (cls, size, dict(config, compute_dtype="float32"), lr,
                                  2000, [(0.125, 0.1), (0.875, 1.0)])
    specs["PFPNetR-tpudet-init"] = (f"{__name__}.PFPNetRFromTpudetInit", size, config, lr,
                                  steps, schedule)
    return specs


if __name__ == "__main__":
    tc.model_specs = model_specs
    sys.exit(tc.main(sys.argv[1:]))
