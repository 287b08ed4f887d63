"""On the card, at each cell's own size: a sound run of the port is
correct, and the control, the port with its matmuls in TF32 (the
precision below the float32 its configuration states), is not."""
import pytest
import torch

from encbench import spec
from encbench.run import run_cell

CELLS = [w["name"] for w in spec.benchmark().get("workloads", [])]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "form and the cells run at their own size")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    card()
    r = run_cell(cell, 2 ** 31 + 101, 6.0, 0, check_pictures=2)
    assert r["correct"], r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell):
    card()
    import x265_tpu_torch  # noqa: F401  (its import turns TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        r = run_cell(cell, 2 ** 31 + 102, 6.0, 0, check_pictures=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    gap = r["checks"]["analysis_gap"]
    assert not r["correct"] and gap["value"] > gap["limit"], r["checks"]
