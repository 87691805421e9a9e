"""More archs of ``test_torch_train_step.py`` (split over three files so
that each stays well under a minute): the port's ``Model.loss_fn`` and its
backward pass against the JAX package's, with the bounds stated there."""
import pytest

from repro.configs import arch_names
from test_torch_train_step import CASES, check_arch

ARCHS_B = [a for a in arch_names()[5:] if a != "jamba-1.5-large-398b"]


@pytest.mark.parametrize("remat,loss_chunk", CASES, ids=["plain", "remat-chunked"])
@pytest.mark.parametrize("arch", ARCHS_B)
def test_loss_and_grads_match_reference(arch, remat, loss_chunk):
    check_arch(arch, remat, loss_chunk)
