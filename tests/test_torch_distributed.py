"""Data parallelism across processes: two CPU ranks over gloo against the JAX
package's step over the whole batch, and the train CLI's ``--mesh``.

Two processes (``chip_smoke.py --dp_worker``, the worker phase util runs on
the card) build salmonn-tiny from the same JAX-initialised weights (carried
across by ``bridge.py``) and each steps one distinct sample; the samples
hold different counts of label tokens, so averaging the ranks' mean losses
(plain DDP) would give another loss and other gradients. The two-rank
step's loss, grad norm, summed gradients and updated trainable leaves must
match JAX's ``make_train_step`` on the full batch, within
``tests/test_torch_training.py``'s tolerances: loss and grad norm 1e-5
relative, gradients 1e-4 and leaves 1e-5 × the max of the leaf's group
(lora.*.a, lora.*.b, qformer: a key bias's gradient is rounding noise, so
its update is noise too and a leaf's own max is no scale for it), with
AdamW's first step in its linear regime (``chip_smoke.DP_OPT``). A label
past the vocabulary on one rank must skip the step on both;
``gather_predictions`` must return every rank's rows on both.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
from icl_speech_text_llm_tpu.training import step as jstep
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.cli import train
from icl_speech_text_llm_tpu_torch.data.packing import IGNORE_INDEX
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The two ranks' results and JAX's full-batch step on the same weights
    (LoRA B drawn non-zero, so every LoRA leaf has a gradient)."""
    cfg = jsalmonn.salmonn_tiny()
    params = _np_tree(jsalmonn.init_salmonn(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(1)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    batch = chip_smoke._dp_batch(tsalmonn.salmonn_tiny())
    ranks = chip_smoke._dp_spawn(str(tmp_path_factory.mktemp("dp")), "file", params, batch,
                                 "cpu", timeout=30)
    opt = jstep.make_optimizer(jstep.OptimizerSettings(**chip_smoke.DP_OPT))
    state, frozen = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), opt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.grad(lambda tr: jsalmonn.salmonn_train_loss(
        cfg, jstep.merge_params(frozen, tr), jbatch))(state.trainable)
    state, metrics = jstep.make_train_step(cfg, opt)(state, frozen, jbatch)
    want = chip_smoke._paths(_np_tree(state.trainable))
    return (ranks, float(metrics["loss"]), float(metrics["grad_norm"]), want,
            chip_smoke._paths(_np_tree(grads)), batch, params)


def test_two_rank_step_equals_jax_full_batch_step(dp_run):
    ranks, loss, norm, want, grads, _, _ = dp_run
    errs = chip_smoke._check_dp_ranks(ranks, 2, loss, norm, want, grads,
                                      "two gloo ranks on the CPU")
    assert all(errs[k] <= chip_smoke.DP_LIMITS[k] for k in errs)
    assert chip_smoke.DP_LIMITS == {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-4,
                                    "leaves": 1e-5}
    # both ranks hold the same replica after the step
    assert set(ranks[0][1]) == set(ranks[1][1])
    for name in ranks[0][1]:
        np.testing.assert_array_equal(ranks[0][1][name], ranks[1][1][name])


def test_the_ranks_label_counts_make_plain_ddp_averaging_wrong(dp_run):
    """The check above can tell the global token mean from the mean of the
    ranks' means: on this batch they differ by far more than its tolerance."""
    ranks, loss, _, _, _, batch, params = dp_run
    counts = (batch["shifted_labels"] != IGNORE_INDEX).sum(axis=1)
    assert [r["label_count"] for r, _ in ranks] == counts.tolist()
    tparams = params_from_numpy(params, device="cpu")
    with torch.no_grad():
        means = [tsalmonn.salmonn_train_loss(
            tsalmonn.salmonn_tiny(), tparams,
            {k: torch.as_tensor(v[i:i + 1]) for k, v in batch.items()}).item()
            for i in range(2)]
    assert np.dot(means, counts) / counts.sum() == pytest.approx(loss, rel=1e-5)
    assert abs(np.mean(means) - loss) > 1e-3 * abs(loss)


def test_nan_on_one_rank_skips_the_step_on_both_and_rows_gather_on_both(dp_run):
    ranks = dp_run[0]
    for res, _ in ranks:
        assert res["nan_skipped"] == 1.0 and res["kept_after_nan"]
        assert sorted(r["index"] for r in res["gathered"]) == [0, 0, 1, 2, 3, 4]
        assert res["broadcast"] == ranks[0][0]["broadcast"]
        assert res["broadcast"]["rank"] == 0
    assert ranks[0][0]["gathered"] == ranks[1][0]["gathered"]


ARGV = ["--model_type", "salmonn-tiny", "--synthetic", "--num_epochs", "1", "--batch_size",
        "2", "--max_samples", "4", "--seq_len", "768", "--text_len", "384",
        "--val_max_samples", "3", "--device", "cpu"]


def test_train_cli_mesh_1_is_the_plain_run(tmp_path):
    """``--mesh 1`` runs the data-parallel step in a group of one (its
    reductions included) and gives the plain run's losses and weights, bit
    for bit; the group is gone when the CLI returns."""
    plain = train.main(ARGV + ["--output_dir", str(tmp_path / "plain")])
    mesh = train.main(ARGV + ["--mesh", "1", "--output_dir", str(tmp_path / "mesh")])
    assert not torch.distributed.is_initialized()
    assert mesh.losses == plain.losses and len(mesh.losses) == 2
    for (name, a), b in zip(chip_smoke._paths(plain.state.trainable).items(),
                            chip_smoke._paths(mesh.state.trainable).values()):
        assert torch.equal(a, b), name
    assert len(mesh.checkpoints) == 1


def test_mesh_spec_parses_as_jax():
    from icl_speech_text_llm_tpu_torch.parallel import mesh as tmesh

    assert tmesh.parse_mesh("4") == (4, 1, 1, 1)
    assert tmesh.parse_mesh("4,2,1") == (4, 2, 1, 1)
    assert tmesh.parse_mesh("2,1,1,2") == (2, 1, 1, 2)
    assert tmesh.AXES == ("dp", "pp", "fsdp", "tp")
    # FSDP, tensor and pipeline parallelism are ported: such a mesh needs
    # its processes
    with pytest.raises(ValueError, match="2 != 1 processes"):
        tmesh.make_mesh(dp=1, tp=2, device="cpu")
    with pytest.raises(ValueError, match=r"dp1xpp2xfsdp1xtp1 = 2 != 1 processes"):
        tmesh.make_mesh(dp=1, pp=2, device="cpu")
    assert not torch.distributed.is_initialized()
