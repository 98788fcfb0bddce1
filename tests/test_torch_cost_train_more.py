"""The train-step FLOP parity of ``tests/test_torch_cost_train.py`` on the
other half of the ten architectures (a file of its own, so the two halves'
compilations run beside each other)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import ARCHS  # noqa: E402
from test_torch_cost_train import check_train_step_flops  # noqa: E402


@pytest.mark.parametrize("arch", ARCHS[5:])
def test_train_step_flops_match_reference_more(arch):
    check_train_step_flops(arch)
