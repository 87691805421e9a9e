"""jamba (attention, MoE and mamba: the slowest arch to compile) of
``test_torch_train_step.py``, split off so that each file stays well under
a minute: the port's ``Model.loss_fn`` and its backward pass against the
JAX package's, with the bounds stated there."""
import pytest

pytest.importorskip("torch")

from test_torch_train_step import CASES, check_arch

ARCHS_C = ["jamba-1.5-large-398b"]


@pytest.mark.parametrize("remat,loss_chunk", CASES, ids=["plain", "remat-chunked"])
@pytest.mark.parametrize("arch", ARCHS_C)
def test_loss_and_grads_match_reference(arch, remat, loss_chunk):
    check_arch(arch, remat, loss_chunk)
