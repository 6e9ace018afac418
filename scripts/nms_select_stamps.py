"""Where the radix-select NMS select kernel (``csrc/nms.cu`` at commit
4d9ba5b: a block a row, the row read once for the live count and once for
each 8-bit digit pass and the winners, a bitonic sort of the winners) spends
its time on the card, by ``clock64()`` stamps.

    git show 4d9ba5b:tpudet_torch/ops/cuda/csrc/nms.cu > build/old_nms/nms.cu
    python3 scripts/nms_select_stamps.py build/old_nms/nms.cu

A copy of that source gets stamps by thread 0 of each block at the ends of
its select's phases (the live count, each digit pass, the winners pass, the
bitonic sort, the write) and is built into ``build/old_nms/`` with the
package's nvcc flags. The stamps are placed by anchors in that version's
text; another version raises. On seeded rows at SSD300 mining's select shape
([32, 8828], the first 768 positions) and RetinaNet decode's ([20, 47961],
512) the select is held == the stable order's head, timed (profiler device
time) and its cycles split by phase, mean over the blocks. Prints the card,
one line a site and one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import chip_smoke  # noqa: E402

STAMPS = 16  # stamp slots a block
BLOCKS = 64  # blocks stamped
PREAMBLE = f"""
__device__ long long tpudet_stamps[{BLOCKS} * {STAMPS}];
__device__ int tpudet_stamping;
#define STAMP(k) do {{ if (tpudet_stamping && threadIdx.x == 0 && blockIdx.x < {BLOCKS}) \\
  tpudet_stamps[blockIdx.x * {STAMPS} + (k)] = clock64(); }} while (0)
"""
ENTRIES = f"""
extern "C" int tpudet_stamps_enable(int on) {{
  return static_cast<int>(cudaMemcpyToSymbol(tpudet_stamping, &on, sizeof on));
}}
extern "C" int tpudet_stamps_read(long long* out) {{
  static const long long zero[{BLOCKS} * {STAMPS}] = {{}};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, tpudet_stamps, sizeof zero);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(tpudet_stamps, zero, sizeof zero);
  return static_cast<int>(err);
}}
"""
# (anchor, text put in place of it): stamp 0 at the start, then the end of
# each phase
STAMP_AT = [
    ("  if (threadIdx.x == 0) s_live = 0;", "  STAMP(0);\n  if (threadIdx.x == 0) s_live = 0;"),
    ("  const int c = block_select(s, n, 0u, kNoCursor, p_count,",
     "  __syncthreads();\n  STAMP(1);\n  const int c = block_select(s, n, 0u, kNoCursor, p_count,"),
    ("    if (whole_bin) break;  // every key matching prefix is a winner",
     "    STAMP(2 + (24 - shift) / 8);\n"
     "    if (whole_bin) break;  // every key matching prefix is a winner"),
    ("  block_sort_desc(sm.words, c);\n  return c;",
     "  STAMP(6);\n  block_sort_desc(sm.words, c);\n  STAMP(7);\n  return c;"),
    ("  if (threadIdx.x == 0) live[b] = s_live;\n}",
     "  if (threadIdx.x == 0) live[b] = s_live;\n  __syncthreads();\n  STAMP(8);\n}"),
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + PREAMBLE),
]
PHASES = ["live count", "digit pass 1", "digit pass 2", "digit pass 3", "digit pass 4",
          "winners", "bitonic sort", "write"]  # the spans ending at stamps 1-8


def stamped_source(text: str) -> str:
    """The select's source with its clock64() stamps and their C entries."""
    for anchor, new in STAMP_AT:
        if text.count(anchor) != 1:
            raise ValueError(f"the stamp anchor is not once in the source: {anchor!r}")
        text = text.replace(anchor, new)
    return text + ENTRIES


def stand_ins(dev):
    """Seeded rows at SSD300 mining's and RetinaNet decode's select shapes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(31)
    mining = rng.exponential(1.0, (32, 8828)).astype(np.float32)
    mining[rng.uniform(size=mining.shape) < 0.05] = chip_smoke.NEG
    retina = rng.uniform(0, 1, (20, 47961)).astype(np.float32)
    retina[rng.uniform(size=retina.shape) < 0.3] = chip_smoke.NEG
    return {"SSD300 mining": (torch.from_numpy(mining).to(dev), 768),
            "RetinaNet decode": (torch.from_numpy(retina).to(dev), 512)}


def split(lib, scores, p):
    """The select == the stable order's head, its device ms, and its cycles
    by phase (mean over the stamped blocks; a digit pass it skipped counts 0)."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    raw = chip_smoke.raw_select(scores, p, lib)
    raw["select"]()
    torch.cuda.synchronize()
    if not torch.equal(raw["order"].long(), nms_kernel.stable_order(scores)[:, :p].long()):
        raise AssertionError("the stamped select != the stable order's head")
    device_ms = chip_smoke.device_ms(raw["select"])
    buf = (ctypes.c_longlong * (BLOCKS * STAMPS))()
    lib.tpudet_stamps_read(buf)  # clears the slots
    lib.tpudet_stamps_enable(1)
    raw["select"]()
    lib.tpudet_stamps_read(buf)
    lib.tpudet_stamps_enable(0)
    blocks = [buf[i * STAMPS:(i + 1) * STAMPS] for i in range(min(BLOCKS, scores.shape[0]))]
    cycles = [0.0] * len(PHASES)
    for st in blocks:
        prev = st[0]
        for i in range(1, len(PHASES) + 1):
            if st[i]:
                cycles[i - 1] += (st[i] - prev) / len(blocks)
                prev = st[i]
    total = sum(cycles)
    return {"device_ms": device_ms, "blocks": len(blocks), "total_cycles": total,
            "cycles": dict(zip(PHASES, cycles)),
            "share": {ph: c / total for ph, c in zip(PHASES, cycles)}}


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("nms_select_stamps: no CUDA device", file=sys.stderr)
        return 1
    source = Path(sys.argv[1]).resolve()
    stamped = source.with_name("stamped.cu")
    stamped.write_text(stamped_source(source.read_text()))
    lib = chip_smoke.old_nms_load(chip_smoke.old_nms_build(stamped, "stamped"))
    lib.tpudet_stamps_enable.argtypes = [ctypes.c_int]
    lib.tpudet_stamps_read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    result = {}
    for site, (scores, p) in stand_ins(torch.device("cuda")).items():
        r = result[site] = split(lib, scores, p)
        print(f"{site} [{scores.shape[0]}, {p}] of {scores.shape[1]}: device "
              f"{chip_smoke.fmt_ms(r['device_ms'])} ms, {r['total_cycles']:.0f} cycles: "
              + ", ".join(f"{ph} {100 * r['share'][ph]:.1f}%" for ph in PHASES), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
