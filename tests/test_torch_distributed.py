"""The port's mesh path on spawned gloo ranks against its one-device path.

The twins of the reference's sharded tests (``tests/test_distributed.py``,
``tests/test_policies.py``) for the dense families, each rank a process
(``tests/_mesh_ranks.py``: the ``spawn`` start method, a ``FileStore`` in
``tmp_path``, no TCP port), in float32 at reduced size.  The oracle is the
port's one-device output on the same weights, which every rank computes.
Tolerances: logits max|Δ| within 1e-5 of the largest |logit|; losses rtol
1e-5 for one step and 1e-4 over five; parameters after five steps within
1e-4 of each leaf's largest entry (at lr 1e-3: Adam's first steps scale
each entry's update by its own gradient, so last-bit gradient differences
move a parameter in proportion to lr; at lr 1e-2 the worst leaf drifts
4.1e-4 of its largest entry); gradients within 1e-4 of the leaf's largest
plus 1e-6 (``tests/test_torch_training.py``); a checkpoint resume bit-exact.
One spawn a mesh, shared by the tests that read it.
"""

import numpy as np
import pytest

from tests._mesh_ranks import spawn


@pytest.fixture(scope="module")
def mesh24(tmp_path_factory):
    return spawn(8, "mesh24", tmp_path_factory.mktemp("mesh24"))


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    return spawn(3, "uneven", tmp_path_factory.mktemp("uneven"))


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b", "qwen2-0.5b-padded"])
def test_forward_sharded_matches_single_device(mesh24, arch):
    assert mesh24["forward"][arch] <= 1e-5


@pytest.mark.slow
def test_fsdp_policy_matches_plain_train_loss(mesh24):
    plain, sharded = mesh24["fsdp"]
    np.testing.assert_allclose(sharded, plain, rtol=1e-5)


@pytest.mark.slow
def test_five_default_steps_match_single_device(mesh24):
    want, got, worst_leaf = mesh24["five"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert worst_leaf <= 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b", "mamba2-130m",
                                  "internvl2-1b", "qwen2-0.5b-padded"])
def test_train_step_runs_sharded_all_dense_families(mesh24, arch):
    want, got = mesh24["families"][arch]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.slow
def test_prefill_and_decode_sharded_match_single_device(mesh24):
    *logits, caches = mesh24["serve"]
    assert len(logits) == 5 and max(logits) <= 1e-5
    assert caches <= 1e-5


@pytest.mark.slow
@pytest.mark.parametrize("heads", ["6/2", "12/4"])
def test_uneven_gqa_groups_on_local_shards(uneven, heads):
    """G 3 cut by the model axis: 2 heads a rank read KV heads [0], [0, 1],
    [1] (slices, G 2, 1, 2); 4 a rank need a copy a head on the first and
    last rank ([0, 0, 0, 1], [2, 3, 3, 3]) and a slice on the middle one."""
    got = uneven[heads]
    if heads == "6/2":
        assert got["sel"] == [[0, 1], [0, 2], [1, 1]]
    else:
        assert got["sel"] == [[0, 0, 0, 1], [1, 2], [2, 3, 3, 3]]
    assert got["logits"] <= 1e-5
    np.testing.assert_allclose(*got["loss"], rtol=1e-5)
    assert got["grad_share"] <= 1.0


@pytest.mark.slow
def test_checkpoint_saved_and_restored_on_a_mesh(tmp_path):
    got = spawn(2, "checkpoint", tmp_path)
    assert got["start"] == 2
    assert got["losses"][0] == got["losses"][1]
    assert got["params_equal"] and got["moments_equal"]
    assert got["manifests_equal"]                # the same leaves as one device's files
