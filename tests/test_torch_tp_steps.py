"""The port's training steps under a (data x model) layout of 2 x 2 ranks
(gloo on the CPU, one ``parallel.dryrun.spawn`` of four ranks whose
children import only the port): the attention heads and FFN hidden units
cut over the two model ranks of each data index, every stream of the batch
over the two data ranks.

* The dryrun's five tiny legs (``parallel.dryrun.tiny_inputs``: the
  supervised step, the mean-teacher step, the sharded bank fed to the step,
  SP-SEDT, the audio-tag step; two steps each, global batch 8) against the
  same legs in one process, at ``dryrun.compare``'s tolerances of the
  data-parallel tests (``tests/test_torch_ddp_steps.py``): the first step's
  gradients, gathered whole over the model group, leaf by leaf to 1e-2 of
  the leaf's largest entry; the global loss to 1e-5 relative (later steps
  1e-3); Adam's first update to 1e-3 of the lr on the entries both
  gradients pin; the replicated parameters bit for bit on all four ranks
  after every step, each cut one bit for bit across its two data ranks;
  the bank's rows the dataset's (a sum over the world would double them);
  the semi step's pseudo counts exactly.
* The supervised step (6 strong | 2 weak rows) from one JAX init against
  the JAX package's step on a 2 x 2 mesh (``make_mesh(MeshConfig(n_model=
  2))`` over 4 of the 8 CPU devices, the parameters placed by
  ``param_sharding``): the loss to 1e-5 relative, every metric and the
  gradients leaf by leaf and the update to the data-parallel test's JAX
  tolerances.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sound_event_detection_transformer_tpu import engine as jengine
from sound_event_detection_transformer_tpu.config import MeshConfig as JMesh
from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.parallel.mesh import (
    make_mesh,
    param_sharding,
    replicated,
    shard_batch_pytree,
)
from sound_event_detection_transformer_tpu.parallel.optim import make_optimizer as jmake_optimizer
from sound_event_detection_transformer_tpu_torch.config import MeshConfig
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.parallel import dryrun
from sound_event_detection_transformer_tpu_torch.weights import from_flax
from test_torch_ddp_steps import (
    STEPS_PER_EPOCH,
    _init,
    _np,
    _sup_batches,
    check_gradients_and_update_match_the_jax_mesh_step,
)
from test_torch_train_step import _configs, _keep_grads

torch.set_num_threads(2)
WORLD, LAYOUT = 4, [2, 2]
LEGS = ["supervised", "semi", "bank", "spsedt", "audio_tag"]


def _jax_tp_step(jcfg, params, frozen, jbatch):
    """The JAX package's train step on a (2 x 2) mesh: the parameters by
    ``param_sharding`` (heads and hidden units over ``model``), the rest
    replicated, the batch over ``data``."""
    mesh = make_mesh(JMesh(n_model=2), jax.devices()[:WORLD])
    jmodel, jwd = jbuild(jcfg)
    tx = optax.chain(_keep_grads(), jmake_optimizer(params, jcfg.train, STEPS_PER_EPOCH))
    rep = lambda tree: jax.device_put(tree, jax.tree.map(lambda _: replicated(mesh), tree))
    state = jengine.TrainState(jax.device_put(params, param_sharding(params, mesh)), rep(frozen),
                               rep(tx.init(params)), jnp.asarray(0))
    batch = shard_batch_pytree(jbatch._replace(indexes=None), mesh)
    step = jengine.make_train_step(jmodel, jwd, jcfg, tx, augment_on=True)
    with mesh:
        new, metrics = step(state, batch, jax.random.PRNGKey(0))
    return {"metrics": {k: np.asarray(v) for k, v in metrics.items()},
            "grads": from_flax(_np(new.opt_state[0]), {}),
            "params": from_flax(_np(new.params), frozen)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (JAX's result or None, world 1's, every rank's at 2 x 2, the
    leg's input)} from one spawn."""
    work = tmp_path_factory.mktemp("tp_steps")
    inputs = dryrun.tiny_inputs("cpu", batch=8, steps=2)
    jb, tb = _sup_batches()
    jcfg, tcfg = _configs(JConfig), _configs(TConfig)
    params, frozen = _init(jcfg, jb.feats, jb.pad_mask)
    want = _jax_tp_step(jcfg, params, frozen, jb)
    inputs["jax_plain"] = dict(leg="step", device="cpu", steps=1, seed=0, cfg=tcfg,
                               state=from_flax(params, frozen), batch=tb, streams=[6, 2],
                               steps_per_epoch=STEPS_PER_EPOCH)
    path = str(work / "inputs.pt")
    torch.save(inputs, path)
    dryrun.spawn(dryrun.run_legs, WORLD, (path, str(work / "out"), list(inputs),
                                          MeshConfig(n_model=2)), str(work), "cpu")
    out = {name: (want if name == "jax_plain" else None, dryrun.LEGS[inp["leg"]](inp),
                  dryrun.load_results(str(work / "out"), name, WORLD), inp)
           for name, inp in inputs.items()}
    shutil.rmtree(work)
    return out


@pytest.mark.parametrize("name", LEGS + ["jax_plain"])
def test_legs_ran_at_2x2_with_the_projections_cut(runs, name):
    _, one, got, inp = runs[name]
    assert one["layout"] == [1, 1] and one["n_cut"] == 0
    assert [r["layout"] for r in got] == [LAYOUT] * WORLD
    assert [r["place"] for r in got] == [[0, 0], [0, 1], [1, 0], [1, 1]]  # d * 2 + m
    cut = {r["n_cut"] for r in got}
    # tiny: 1 + 2 layers, 5 attentions of 7 cut leaves, 3 FFNs of 3
    assert cut == ({0} if inp["leg"] == "audio_tag" else {44}), cut


@pytest.mark.parametrize("name", LEGS + ["jax_plain"])
def test_2x2_equals_world_1(runs, name):
    _, one, got, inp = runs[name]
    lr, wd = dryrun.lr_and_decay(inp)
    res = dryrun.compare(one, got, inp["state"], lr, wd)
    assert res["grad_err"] <= 1e-2 and res["loss_rel"] <= 1e-5, res
    assert res["later_rel"] <= 1e-3, res
    assert res["update_err"] <= 1e-3 and res["pinned"] > 0.9, res
    assert res["in_bound"] and res["frozen_equal"] and res["ok"], res


@pytest.mark.parametrize("name", LEGS + ["jax_plain"])
def test_replicated_parameters_are_bit_for_bit_on_every_rank(runs, name):
    _, _, got, inp = runs[name]
    steps = inp["steps"] if inp["leg"] != "bank" else len(inp["indexes"])
    for r in got:
        assert r["replicated_equal"] == [True] * steps and r["cut_equal"] == [True] * steps
        assert r["ranks_equal"] == [True] * steps


def test_bank_rows_are_the_datasets(runs):
    """Each data rank's gathered rows are its share of the dataset's: the
    masked sum runs over the data group, so the two model ranks holding one
    shard do not double them."""
    _, one, got, _ = runs["bank"]
    assert all(all(r["bank_equal"]) for r in got) and all(one["bank_equal"])
    assert all(r["sharded"] for r in got)


def test_semi_pseudo_counts_equal_world_1(runs):
    _, one, got, _ = runs["semi"]
    for a, b in zip(got[0]["metrics"], one["metrics"]):
        np.testing.assert_array_equal(a["pseudo_counts"], b["pseudo_counts"])


def test_2x2_step_matches_the_jax_2x2_mesh_step(runs):
    """The losses and metrics against JAX's (2 x 2) mesh step, then the
    gradients leaf by leaf and the update (the data-parallel test's JAX
    tolerances)."""
    want, _, got, _ = runs["jax_plain"]
    metrics = got[0]["metrics"][0]
    assert set(metrics) == set(want["metrics"])
    loss, want_loss = float(metrics["loss"]), float(want["metrics"]["loss"])
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(metrics[k], w, atol=1e-4, rtol=1e-4, err_msg=k)
    check_gradients_and_update_match_the_jax_mesh_step(runs["jax_plain"])
