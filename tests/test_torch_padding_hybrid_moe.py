"""Mesh padding of the reduced hybrid and MoE configs on the port against the
JAX package's, on the CPU: ``test_torch_padding.py``'s model tests, with its
tolerances, on each distinct padded config of ``recurrentgemma-2b`` (MQA,
RG-LRU layers, local attention with a window of 16) and
``granite-moe-3b-a800m`` (8 experts, top-2) at tp 2, 4 and 8, with and
without ``pad_kv``.  A file of its own so that the two halves run on
separate workers.
"""

import pytest

from tests.test_torch_padding import (  # noqa: F401  (collected here with this file's cases)
    _cases, build_case, test_padded_forward_and_loss_match_the_reference,
    test_padded_gradients_match_jax_grad_and_pad_slots_are_zero,
    test_padded_model_is_drawn_at_the_padded_sizes, test_padded_model_is_the_unpadded_model,
    test_padded_prefill_and_decode_match_the_reference,
    test_padded_remat_policies_give_the_same_bits)

case = pytest.fixture(scope="module", params=_cases(
    ("recurrentgemma-2b", "granite-moe-3b-a800m")))(build_case)
