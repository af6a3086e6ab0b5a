"""``test_torch_loss.py``'s loss and gradient parity for the MoE ids
(deepseek-moe-16b, deepseek-v2-236b) at SMOKE, in a file of their own:
JAX runs their MoE op by op (``lm_parity.jax_mode``), ~20-30 s each for
the value and gradient. The routers pick the same experts in both
packages on these tokens (a flip would make the gradients incomparable,
and fails the test)."""
import pytest

import lm_parity as lp
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_loss_and_gradients_match_jax_moe(arch):
    worst = lp.assert_loss_and_grads_close(arch)
    print(f"{arch}: worst gradient normwise {worst:.4g}")
