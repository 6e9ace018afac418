"""``python tests/torch_flax_init.py NAME`` (tpudet's initial weights for
the port's ``NAME-tpudet-init`` variant of
``scripts/convergence_variants_torch.py``), for a small CenterNet and a
small PFPNetR: the file loads strictly into the variant's class, with
flax's ``weight_decay * global_l2``. Most of the time is flax's own eager
initialisation of each net (~25-30 s).
"""

import importlib

import pytest
import torch

import torch_flax_init
from tpudet_torch.models.base import global_l2

SIZE = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def variants():
    torch_flax_init._paths()
    return importlib.import_module("convergence_variants_torch")


@pytest.mark.parametrize("name", ["CenterNet", "PFPNetR"])
def test_flax_init_file_loads_strictly_with_flaxs_l2(name, variants, tmp_path, monkeypatch):
    """``main([NAME])`` at 64x64 into a scratch file, then the variant's
    class built at 64x64 from that file: ``strict`` loading, and the port's
    ``weight_decay * global_l2`` of the loaded net equal to tpudet's of
    flax's init to float32 summation order (1e-6 relative)."""
    out = tmp_path / f"{name}.pt"
    terms = []
    real = torch_flax_init.flax_init_state

    def spy(*args):
        state, term = real(*args)
        terms.append(term)
        return state, term

    monkeypatch.setattr(torch_flax_init, "flax_init_state", spy)
    torch_flax_init.main([name], size=(SIZE, SIZE), out=str(out))
    monkeypatch.setattr(variants, "init_path", lambda spec: str(out))
    cls = variants.from_tpudet_init(name)
    assert cls.__bases__[0] is variants.tc._load_class(variants.tc.model_specs()[name][0])
    _, config = torch_flax_init.spec_class(name, (SIZE, SIZE))
    sized = type(cls.__name__, (cls,), {"input_size": SIZE})
    pm = sized(config, None, device="cpu")
    state = torch.load(out)
    assert pm.net.state_dict().keys() == state.keys()
    assert all(torch.equal(v, state[k]) for k, v in pm.net.state_dict().items())
    with torch.no_grad():
        got = pm.weight_decay * float(global_l2(pm.net.parameters()))
    (want,) = terms
    assert abs(got / want - 1) < 1e-6, (got, want)
