"""The benchmark's CPU tests (run from the repository's root:
`python -m pytest port_bench/tests -q`). Tests of what runs on the card
carry the `cuda` marker and skip, from inside a fixture, without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the small size the CPU tests run the cells at: the program's plain
# PyTorch versions of its kernels, a few filters, 32 x 32 slices
SMALL_CFG = dict(data_size=32, n_G_filters=4, cohort_slices=16,
                 infer_batch=2, batch_size=2)
SMALL_TRAFFIC = dict(pool_slices=16, volume_slices=[2, 6],
                     protocol_slices=8, check_volumes=2, trace_volumes=1)


@pytest.fixture
def small_program(monkeypatch):
    """The program's serving defaults at the small width (its serving
    closures build their nets from the trainers' DEFAULTS)."""
    import torch
    from ideal_gan_tpu_torch.train import teaug, unsup
    torch.set_num_threads(4)
    monkeypatch.setitem(unsup.DEFAULTS, "n_G_filters",
                        SMALL_CFG["n_G_filters"])
    monkeypatch.setitem(teaug.DEFAULTS, "n_G_filters",
                        SMALL_CFG["n_G_filters"])


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
