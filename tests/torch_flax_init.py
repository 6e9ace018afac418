"""Write flax's own initial variables of tpudet's PFPNetR convergence spec
(``scripts/train_convergence.py``) as the port's ``state_dict``, to
``build/pfpnet_tpudet_init.pt`` (~211 MB), for
``scripts/convergence_variants_torch.py PFPNetR-tpudet-init``:

    python tests/torch_flax_init.py

tpudet's model initialises as it does in a run (``net.init`` with
``PRNGKey(seed)``, seed 0, on a zero image of the spec's input); ``jax.random``
gives the same values on any backend. It needs JAX and tpudet (~35 s on
the CPU) and prints the tensors' count, the parameters' count and
``weight_decay * global_l2`` of the result.
"""

import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "pfpnet_tpudet_init.pt"


def main():
    sys.path[:0] = [str(REPO), str(REPO / "scripts")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch
    import train_convergence as tpudet_script
    from tpudet.models.refinedet import PFPNetR
    from tpudet_torch.runtime import transfer

    _, _, config, _, _, _ = tpudet_script.model_specs()["PFPNetR"]
    script_keys = ("gt_pad", "host_feed", "chunk_bytes", "rotate_every", "max_bytes")
    config = {k: v for k, v in config.items() if k not in script_keys}
    model = PFPNetR(dict(config, mode="test"))
    state = transfer.from_flax({"params": jax.device_get(model.params),
                                "batch_stats": jax.device_get(model.batch_stats)})
    params = [v for k, v in state.items() if not k.endswith((".mean", ".var"))]
    l2 = sum(0.5 * float((p.double() ** 2).sum()) for p in params)
    os.makedirs(OUT.parent, exist_ok=True)
    torch.save(state, OUT)
    print(f"{OUT}: {len(state)} tensors, {sum(p.numel() for p in params)} parameters, "
          f"weight_decay * global_l2 = {config['weight_decay'] * l2:.5f}")


if __name__ == "__main__":
    main()
