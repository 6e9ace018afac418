"""Data parallelism over several cards on NCCL, one rank a card: SSD300 at
``chip_smoke.py``'s phase 4 config and batch (bf16, batch 32) over every
card of the machine against one card without a process group, then
``entry_torch.dryrun_multichip`` over the cards. Needs two or more cards;
imports no JAX. Prints one JSON line last.

    python tests/torch_dp_cards.py

Held as phase 19 (b) holds two ranks sharing one card: the first step's loss
within 2e-4 and the parameters after it within 5e-4 of one card's (tpudet's
own tolerances), the second loss within 1e-2 (a bf16 step's), every rank's
state bitwise equal; each rank's kernel launches counted. Then timed steps
on every rank, and the reductions alone.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import entry_torch  # noqa: E402
from tpudet_torch.runtime import mesh as mesh_lib  # noqa: E402

TIMED_STEPS = 10


def _rank(rank, world):
    cs.tf32_off()
    images, gt = cs.train_batch()
    model = cs.dp_model(cs.TRAIN_BATCH, images, gt, cs.DP_STEPS)
    if model.mesh.world != world or torch.distributed.get_backend() != "nccl":
        raise AssertionError(f"rank {rank}: {model.mesh}")
    cs.reset_kernel_counts()
    losses = cs.dp_steps(model, 1)
    first = cs.dp_state(model) if rank == 0 else None
    losses += cs.dp_steps(model, 1)
    counts = cs.kernel_counts()
    digest = cs.dp_digest(cs.dp_state(model))
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs.dp_steps(model, TIMED_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / TIMED_STEPS
    return dict(losses=losses, first=first, digest=digest, counts=counts, step_ms=step_ms,
                reduce=cs.reduce_ms(model))


def main() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        print(f"torch_dp_cards: {n} card(s); this needs two or more", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpudet_torch.ops.cuda import build

    for name in ("nms", "assign"):
        build.build(name)
    card = cs.card_line()
    images, gt = cs.train_batch()
    one = cs.dp_model(cs.TRAIN_BATCH, images, gt, cs.DP_STEPS)
    one_losses = cs.dp_steps(one, 1)
    one_first = cs.dp_state(one)
    one_losses += cs.dp_steps(one, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs.dp_steps(one, TIMED_STEPS)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t) * 1e3 / TIMED_STEPS
    del one
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mesh_lib.launch(_rank, n, tmp, n, backend="nccl",
                                devices=[f"cuda:{r}" for r in range(n)], timeout=900)
    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], one_losses)]
    params = [k for k in one_first if not k.startswith("velocity/")
              and not k.endswith((".mean", ".var"))]
    worst = max(float((ranks[0]["first"][k] - one_first[k]).abs().max()) for k in params)
    per = cs.TRAIN_BATCH // n
    ok = (rel[0] <= cs.DP_LOSS_RTOL and max(rel) <= cs.DP_BF16_STEP_RTOL
          and worst <= cs.DP_PARAM_ATOL and len({r["digest"] for r in ranks}) == 1
          and all((r["counts"]["assign"], r["counts"]["sorted_scan"]) == (2, 2)
                  for r in ranks))
    print(f"{n} NCCL ranks, a card each, {per} rows a rank: losses {ranks[0]['losses']} "
          f"vs one card's {one_losses} (rel {rel}); parameters after the first step "
          f"within {worst:.2e}; ranks bitwise equal: {len({r['digest'] for r in ranks}) == 1}; "
          f"a step {[round(r['step_ms'], 2) for r in ranks]} ms on the ranks against "
          f"{one_ms:.2f} ms on one card; the flat reduction "
          f"{[round(r['reduce']['ms'], 4) for r in ranks]} ms on the card, a BatchNorm's "
          f"{[round(r['reduce']['batchnorm_host_ms'], 4) for r in ranks]} ms [{card}]",
          flush=True)
    entry_torch.dryrun_multichip(n)
    print(json.dumps({"ok": ok, "card": card, "ranks": n, "loss_rel": rel,
                      "param_max_abs_first": worst, "one_card_step_ms": one_ms,
                      "rank_step_ms": [r["step_ms"] for r in ranks],
                      "reduce": [r["reduce"] for r in ranks],
                      "counts": [r["counts"] for r in ranks]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
