"""The port's expert parallelism and the KV-head policy on spawned gloo ranks.

One world of 8 ranks on a (2, 4) ("data", "model") mesh
(``tests/_mesh_ranks.py``'s ``moe24`` job: the ``spawn`` start method, a
``FileStore`` in ``tmp_path``, no TCP port), in float32 at reduced size;
the twins of the reference's ``test_moe_sharded_matches_local``,
``test_moe_a2a_dispatch_matches_local`` and
``test_decode_kv_policy_matches_plain_decode``.  Every rank computes the
oracle itself on the same weights.  Tolerances are
``tests/test_torch_distributed.py``'s for the dense families: logits max|Δ|
within 1e-5 of the largest |logit|; losses rtol 1e-5 (the first step) and
1e-4 (three); parameters after three steps at lr 1e-3 within 1e-4 of each
leaf's largest entry; the MoE layer's output within 1e-5 of its largest
entry and each gradient within 1e-4 of the leaf's largest plus 1e-6
(``tests/test_torch_training.py``).

* Reduced Granite and Qwen3-MoE (8 experts top-2, 2 per model rank, no
  choice dropped at their capacity factor 8) under ``default``,
  ``fsdp_ep``, ``moe_noseq`` and ``moe_a2a``: forward and three training
  steps against the port's one-device path.
* The layer alone (8 sequences of 16) with choices dropped (capacity
  factor 0.5), with 8 and with 6 experts (padded to 8: the last model rank
  holds only padding experts), under the four policies and ``fsdp``
  (whose batch shards over ``model`` too, gathered on the batch dim into
  the region): the gather paths against ``apply_moe_local`` (capacity per
  sequence, as one device), the all-to-all path against ``_moe_a2a`` run
  in one process over the stacked shards (capacity per source shard),
  output and the gradients of the tokens, the router (a partial sum over
  ``model`` and ``data``) and the expert weights.
* ``decode_kv`` on the reduced Qwen2 with 6 heads over 2 KV heads, padded
  with ``pad_kv`` to 12 over 4 (one KV head a model rank): prefill and
  four decode steps against one device's run of the same padded config.
"""

import numpy as np
import pytest

from tests._mesh_ranks import LAYER_POLICIES, MOE_ARCHS, MOE_POLICIES, spawn


@pytest.fixture(scope="module")
def moe24(tmp_path_factory):
    return spawn(8, "moe24", tmp_path_factory.mktemp("moe24"))


CELLS = [f"{a}/{p}" for a in MOE_ARCHS for p in MOE_POLICIES]


@pytest.mark.slow
@pytest.mark.parametrize("cell", CELLS)
def test_moe_forward_sharded_matches_single_device(moe24, cell):
    assert moe24["forward"][cell] <= 1e-5


@pytest.mark.slow
@pytest.mark.parametrize("cell", CELLS)
def test_moe_three_steps_match_single_device(moe24, cell):
    want, got, worst_leaf = moe24["train"][cell]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert worst_leaf <= 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("policy", LAYER_POLICIES)
@pytest.mark.parametrize("experts", ["drops", "six"])
def test_moe_layer_and_its_gradients_match_the_oracle(moe24, experts, policy):
    got = moe24["layer"][f"{experts}/{policy}"]
    assert got["placed"]                       # the output on the stream's placements
    assert got["out"] <= 1e-5
    assert set(got["grads"]) == {"router", "w_gate", "w_up", "w_down", "x"}
    assert max(got["grads"].values()) <= 1.0


@pytest.mark.slow
def test_decode_kv_prefill_and_decode_match_single_device(moe24):
    got = moe24["decode_kv"]
    assert got["heads"] == [12, 4]
    assert got["wk_placements"] == ["R", "S(1)"]          # KV heads over model
    assert got["cache_placements"] == ["S(0)", "S(2)"]    # batch over data, heads over model
    *logits, caches = got["errs"]
    assert len(logits) == 5 and max(logits) <= 1e-5
    assert caches <= 1e-5
