"""tpudet's RetinaNet and the port's, side by side for a few fp32 steps on the
CPU at the training driver's config (500x500, bottleneck [3, 4, 6, 3], lr
0.01), cut to batch 2, on one fixed seeded batch, from the same weights.

    python tests/torch_retina_trajectory.py [steps]

Prints each step's loss on both sides. Not a pytest module: a 500x500 step
takes seconds on the CPU.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
os.environ["TPUDET_SSD_CONF_LAYOUT"] = "ac"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import test_torch_retina as parity  # noqa: E402
from tpudet.models.retinanet import RetinaNet as JaxRetinaNet  # noqa: E402
from tpudet_torch.models import RetinaNet  # noqa: E402
from tpudet_torch.runtime import transfer  # noqa: E402


def main(steps: int = 5):
    cfg = dict(chip_smoke.RETINA_CONFIG, compute_dtype="float32", batch_size=2)
    images, gt = chip_smoke.retina_batch(4, 2, 500)
    jm = JaxRetinaNet(dict(cfg, mode="test"))
    params, bstats = jax.device_get(jm.params), jax.device_get(jm.batch_stats)
    velocity = parity._tree_like(params, lambda v: np.zeros(np.shape(v), np.float32))
    pm = RetinaNet(cfg, device="cpu")
    transfer.load_flax(pm.net, {"params": params, "batch_stats": bstats})
    for i in range(steps):
        loss, params, bstats, velocity = parity._jax_step(
            jm, params, bstats, velocity, images, gt, 0.01, cfg["weight_decay"])
        port = float(pm.train_step(*pm._to_device(images, gt), 0.01))
        print(f"step {i}: tpudet {float(loss):.6f}  port {port:.6f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
