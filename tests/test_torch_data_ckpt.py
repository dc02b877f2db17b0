"""The port's data pipeline, checkpoints and training driver against the
JAX package's, on the CPU.

Batches are numpy arrays drawn from the same seeded streams, so they
must equal the reference's bit for bit.  Checkpoints share one on-disk
format: a checkpoint written by either package restores in the other,
leaf for leaf and bit for bit (the reference's ``restore`` hands bf16
leaves back as 2-byte void records, read here as bfloat16).
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.checkpoint.store import CheckpointStore as RStore
from repro.checkpoint.store import tree_paths as ref_tree_paths
from repro.data import pipeline as rpipe
from repro.optim import adamw as radamw
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch import device as tdev
from repro_torch.checkpoint.store import CheckpointStore as TStore
from repro_torch.checkpoint.store import tree_paths
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import StragglerWatchdog, train
from repro_torch.models import params as tparams
from repro_torch.optim import adamw as tadamw


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_synthetic_lm_matches_reference(n_hosts):
    cfg = dict(vocab=1000, seq_len=96, global_batch=8, seed=3,
               mean_doc_len=40)
    for host in range(n_hosts):
        want = rpipe.SyntheticLM(rpipe.DataConfig(**cfg), host, n_hosts)
        got = tpipe.SyntheticLM(tpipe.DataConfig(**cfg), host, n_hosts)
        for step in (0, 1, 7):
            _equal(got.batch(step), want.batch(step))


@pytest.mark.parametrize("name", ["llama3_8b", "pixtral_12b",
                                  "hubert_xlarge"])
def test_synthetic_batch_matches_reference(name):
    """Text, vision (a stub patch prefix) and audio (frame embeddings)."""
    for seed in (0, 5):
        _equal(tpipe.synthetic_batch(tconfigs.get_smoke(name), 2, 32, seed),
               rpipe.synthetic_batch(rconfigs.get_smoke(name), 2, 32, seed))


def _state(seed=0):
    """A bf16 parameter tree and an AdamWState over it, as numpy."""
    rng = np.random.default_rng(seed)
    params = {"top": {"tok_embed": rng.standard_normal((6, 4)).astype(
                  ml_dtypes.bfloat16),
                      "final_norm": rng.standard_normal(4).astype(
                  np.float32)},
              "blocks": ({"wk": rng.standard_normal((2, 4, 4)).astype(
                  ml_dtypes.bfloat16)},)}
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params)
    nu = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32),
                      params)
    return params, (np.int32(7), mu, nu)


def _torch_state(seed=0):
    params, (step, mu, nu) = _state(seed)
    to = lambda t: tdev.to_torch(t, "cpu")  # noqa: E731
    return {"params": to(params),
            "opt": tadamw.AdamWState(torch.tensor(step), to(mu), to(nu))}


def _jax_state(seed=0):
    params, (step, mu, nu) = _state(seed)
    to = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return {"params": to(params),
            "opt": radamw.AdamWState(jnp.asarray(step), to(mu), to(nu))}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.kind == "V" else \
        np.ascontiguousarray(a).view(np.uint8)


def test_paths_are_jax_keystrs():
    assert tree_paths(_torch_state()) == ref_tree_paths(_jax_state())
    cfg = tconfigs.get_smoke("jamba_1_5_large_398b")
    tree = tparams.init_params(cfg, 0, "cpu")
    state = {"params": tree, "opt": tadamw.adamw_init(tree)}
    want = [jax.tree_util.keystr(kp) for kp, _ in
            jax.tree_util.tree_leaves_with_path(
                jax.tree.map(lambda t: t.shape, state,
                             is_leaf=lambda x: isinstance(x, torch.Tensor)))]
    assert tree_paths(state) == want


def test_round_trip_bf16_and_adamw_state(tmp_path):
    state = _torch_state()
    store = TStore(str(tmp_path))
    store.save(4, state)
    assert store.latest_step() == 4
    got = store.restore(4, state)
    assert isinstance(got["opt"], tadamw.AdamWState)
    for g, w in zip(_tree.leaves(got), _tree.leaves(state)):
        w = tdev.leaf_to_numpy(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_async_save_commits_after_wait(tmp_path):
    state = _torch_state()
    store = TStore(str(tmp_path))
    store.save(3, state, blocking=False)
    store.wait()
    assert store.latest_step() == 3
    assert os.path.exists(tmp_path / "step_00000003" / "COMMITTED")


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    RStore(str(tmp_path)).save(9, _jax_state(1))
    like = _torch_state()
    got = TStore(str(tmp_path)).restore(9, like)
    want = _torch_state(1)
    for g, w in zip(_tree.leaves(got), _tree.leaves(want)):
        np.testing.assert_array_equal(_bits(g), _bits(tdev.leaf_to_numpy(w)))
    # into live tensors, as the driver resumes
    for t, a, w in zip(_tree.leaves(like), _tree.leaves(got),
                       _tree.leaves(want)):
        t.copy_(tdev.leaf_to_torch(a, "cpu"))
        assert torch.equal(t, w)


def test_port_checkpoint_restores_in_jax(tmp_path):
    TStore(str(tmp_path)).save(2, _torch_state(2))
    like = _jax_state()
    got = RStore(str(tmp_path)).restore(2, like)
    want = _jax_state(2)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    manifest = json.loads((tmp_path / "step_00000002" /
                           "manifest.json").read_text())
    assert [m["path"] for m in manifest["leaves"]] == ref_tree_paths(like)
    assert manifest["leaves"][0]["dtype"] == "int32"  # the step, as jax


def test_uncommitted_directories_are_ignored(tmp_path):
    store = TStore(str(tmp_path))
    assert store.latest_step() is None
    store.save(5, _torch_state())
    (tmp_path / "step_00000009.tmp").mkdir()  # a save cut short
    (tmp_path / "step_00000011").mkdir()  # written, never committed
    (tmp_path / "notes").mkdir()
    assert store.latest_step() == 5
    assert RStore(str(tmp_path)).latest_step() == 5


def test_restore_checks_shapes_and_paths(tmp_path):
    store = TStore(str(tmp_path))
    store.save(1, _torch_state())
    bad = _torch_state()
    bad["params"]["top"]["final_norm"] = torch.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        store.restore(1, bad)
    renamed = _torch_state()
    renamed["params"]["top"]["z_norm"] = \
        renamed["params"]["top"].pop("final_norm")
    with pytest.raises(ValueError, match="final_norm"):
        store.restore(1, renamed)


def test_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(alpha=0.5, k=2.0)
    assert [wd.observe(i, dt) for i, dt in
            enumerate([1.0, 1.0, 5.0, 1.0])] == [False, False, True, False]
    assert wd.flagged == [2]


def test_train_driver_end_to_end(tmp_path):
    """The reference's ``tests/test_launch.py`` drive: 12 steps with a
    checkpoint every 6, then a resume that runs steps 12 and 13 only."""
    args = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "64", "--ckpt-dir", str(tmp_path)]
    losses = train(args + ["--steps", "12", "--ckpt-every", "6",
                           "--log-every", "6"])
    assert len(losses) == 12
    assert all(np.isfinite(l) for l in losses)
    assert TStore(str(tmp_path)).latest_step() == 12
    losses2 = train(args + ["--steps", "14"])
    assert len(losses2) == 2  # steps 12..13 only


def test_train_driver_refuses_autotune(capsys):
    # --autotune runs since the autotuner is ported; a cadence below one
    # step is what it refuses
    args = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "16", "--autotune"]
    with pytest.raises(ValueError, match="autotune-every"):
        train(args + ["--autotune-every", "0"])
    assert len(train(args + ["--autotune-every", "1"])) == 2
    assert "[autotune] refits=0 installs=0 plans_dropped=0 " \
        "reservoirs={'stacked': 2}" in capsys.readouterr().out
