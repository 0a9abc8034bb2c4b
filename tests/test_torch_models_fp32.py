"""The port's model stack against repro's with fp32 params, on the CPU:
the fp32 half of ``tests/test_torch_models.py`` (which runs the bf16
params), in a file of its own so that each half's reference compiles run
on a worker of their own.

Per ``ARCH_ID``: the reference's params built at ``dtype=float32`` and
carried across, ``forward``, ``prefill`` and 4 ``decode_step``s in both
packages on the same tokens, every logit and float cache leaf within
``FP32_TOL = 1e-3`` of the reference's max abs (measured gaps 2e-6 to
1.2e-4: fp32 steps amplified by the depth), the integer cache leaves
exact; and ``loss_fn``'s value and parts within the same tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as tcf
from repro_torch.models import transformer as TT
from test_torch_layers import carry
from test_torch_models import FP32_TOL, _run_ref, check_against_reference


@pytest.fixture(scope="module")
def ref_runs():
    return {a: _run_ref(a, "float32") for a in tcf.ARCH_IDS}


@pytest.mark.parametrize("arch", tcf.ARCH_IDS)
def test_forward_prefill_decode_match_reference(arch, ref_runs):
    check_against_reference(arch, "float32", ref_runs[arch])


def test_loss_fn_matches_reference(ref_runs):
    import jax.numpy as jnp

    from repro.configs import get_smoke
    from repro.models import transformer as T
    for arch in ("llama3_8b", "granite_moe_1b"):
        ref = ref_runs[arch]
        labels = np.roll(ref["toks"], -1, axis=1)
        want, parts = T.loss_fn(get_smoke(arch), ref["params"],
                                jnp.asarray(ref["toks"]),
                                jnp.asarray(labels))
        got, tparts = TT.loss_fn(tcf.get_smoke(arch), carry(ref["params"]),
                                 torch.from_numpy(ref["toks"]),
                                 torch.from_numpy(labels))
        assert abs(float(got) - float(want)) <= FP32_TOL * abs(float(want))
        for k in ("ce", "z", "moe"):
            assert abs(float(tparts[k]) - float(parts[k])) <= \
                FP32_TOL * max(abs(float(parts[k])), 1e-6), k
