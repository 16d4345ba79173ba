"""The benchmark's own tests: the checkout's root on the import path, and
small copies of the configurations for the CPU."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: the small copies: 2048 TOAs, every DMX range holding TOAs
SMALL = {
    "msp_rn_1e5": {"ntoa": 2048, "ndmx": 12},
    "msp_ecorr_8k": {"nepoch": 32, "per_epoch": 64, "ndmx": 24},
}

#: parameters held in a small copy: at 2048 TOAs in 32 sessions SINI's
#: uncertainty is wider than 1 - SINI = 0.002, so a fit of the ECORR
#: copy can leave the range where the Shapiro delay is defined (the
#: full-size cell fits SINI, to 4e-4-1.2e-3)
SMALL_FROZEN = {"msp_ecorr_8k": ["SINI"]}


def small_config(name: str) -> dict:
    from portbench import harness

    cfg = harness.load_json("configs", name)
    size = dict(SMALL[name])
    cfg["par"]["args"]["ndmx"] = size.pop("ndmx")
    cfg["toas"].update(size)
    if name in SMALL_FROZEN:
        cfg["par"]["frozen"] = SMALL_FROZEN[name]
    return cfg


#: the small copies' start offsets, as a share of the cells': their
#: uncertainties are wider, and SINI must stay below 1
SMALL_OFFSETS = 0.1


def small_offsets(offsets: dict) -> dict:
    return {k: str(SMALL_OFFSETS * float(v)) for k, v in offsets.items()}


def small_cell(name: str) -> dict:
    from portbench import harness

    cell = harness.load_cell(name)
    cell["config"] = dict(small_config(cell["config"]["name"]),
                          name=cell["config"]["name"])
    cell["start"]["offsets"] = small_offsets(cell["start"]["offsets"])
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
