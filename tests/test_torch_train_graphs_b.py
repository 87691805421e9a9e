"""The MoE case of ``test_torch_train_graphs.py``'s differential (split
off so that each file stays well under a minute): the staged step program
at ``qwen3-moe-30b-a3b-tiny`` against the JAX package's ``Trainer``, in
every variant and with the bounds stated there."""
import pytest

pytest.importorskip("torch")

from test_torch_train_graphs import VARIANTS, _ids, check_variant


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_staged_step_matches_reference(variant):
    check_variant("qwen3-moe-30b-a3b-tiny", variant)
