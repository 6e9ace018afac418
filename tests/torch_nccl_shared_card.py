"""Whether NCCL runs two ranks on one card: two processes on ``cuda:0`` join
one NCCL group and all-reduce one tensor. NCCL is expected to refuse it
("Duplicate GPU detected"); the ranks' errors go to standard error. Prints
one JSON line with the outcome. Needs a card; imports no JAX.

    python tests/torch_nccl_shared_card.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tpudet_torch.runtime import mesh as mesh_lib  # noqa: E402


def _rank(rank):
    x = torch.full((4,), float(rank + 1), device=mesh_lib.local_device())
    torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    return x.cpu().tolist()


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        try:
            out = mesh_lib.launch(_rank, 2, tmp, backend="nccl",
                                  devices=["cuda:0", "cuda:0"], timeout=180)
            result = {"refused": False, "sums": out}
        except (RuntimeError, TimeoutError) as err:
            result = {"refused": True, "error": f"{type(err).__name__}: {err}"}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
