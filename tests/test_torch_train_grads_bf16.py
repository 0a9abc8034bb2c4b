"""The port's gradients of ``loss_fn`` against ``jax.value_and_grad`` of
repro's with the reference's bf16 params, on the CPU: the bf16 half of
``tests/test_torch_train_grads.py``, whose docstring gives the
tolerances and the measurements behind them.
"""
import pytest

from repro_torch import configs as tcf
from test_torch_train import one_torch_thread  # noqa: F401
from test_torch_train_grads import check_grads, ref_grads


@pytest.fixture(scope="module")
def refs():
    return {a: ref_grads(a, "bfloat16") for a in tcf.ARCH_IDS}


@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_gradients_match_value_and_grad(arch, refs):
    check_grads(arch, "bfloat16", refs[arch])
