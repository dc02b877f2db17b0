"""The port's serving entry point (``repro_torch.launch.serve``) on the CPU.

``serve_loop`` must produce the greedy tokens of the JAX package's own
serving loop (``src/repro/launch/serve.py``: a prefill into the cache,
then single-token decode steps, argmax each) over the same weights,
carried across with ``params.from_reference``.  Greedy tokens are
compared exactly: with fp32 smoke weights the top logit leads the next
by far more than the 3e-4 the two frameworks differ by.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.models.model import Model as RModel
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel

B, P, G = 2, 8, 5


@functools.cache
def _reference_run(name):
    """Weights from PRNGKey(0) and the JAX serve loop's tokens."""
    cfg = rconfigs.get_smoke(name)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    model = RModel(cfg, mesh)
    params = model.init_params(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, (B, P)).astype(np.int32)
    prefill = jax.jit(lambda p, c, t: model.serve_step(
        p, c, t, 0, last_only=True))
    decode = jax.jit(model.decode_step)
    with jax.set_mesh(mesh):
        cache = model.init_cache(B, P + G)
        logits, cache = prefill(params, cache, jnp.asarray(prompts))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        out = [tok]
        for i in range(G - 1):
            logits, cache = decode(params, cache, tok[:, None], P + i)
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            out.append(tok)
    return (jax.tree.map(np.asarray, params), prompts,
            np.stack([np.asarray(t) for t in out], axis=1))


@pytest.mark.parametrize("name", ["llama3_8b", "rwkv6_1_6b",
                                  "qwen2_moe_a2_7b"])
def test_serve_loop_tokens_match_reference(name):
    params, prompts, want = _reference_run(name)
    cfg = tconfigs.get_smoke(name)
    model = TModel(cfg, (1, 1), device="cpu")
    tp = model.load_params(tparams.from_reference(params, cfg, "cpu"))
    res = tserve.serve_loop(model, tp, prompts, G)
    np.testing.assert_array_equal(res.tokens, want)
    assert len(res.step_s) == G - 1 and res.prefill_s > 0
    assert res.tok_per_s() > 0
    # the prefill's logits are the forward's at the last position
    full, _ = model.forward(tp, torch.from_numpy(prompts))
    np.testing.assert_allclose(res.prefill_logits.numpy(),
                               full[:, -1].numpy(), atol=3e-4, rtol=3e-3)


def test_cli_serves_a_smoke_model(capsys):
    out = tserve.serve(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert out.shape == (2, 3)
    assert out.min() >= 0 and out.max() < tconfigs.get_smoke("llama3_8b").vocab
    text = capsys.readouterr().out
    for line in ("prefill 6 tokens x 2 reqs", "decode 2 steps x 2 reqs",
                 "decode step latency: p50", "first request tokens"):
        assert line in text


def test_cli_is_deterministic_in_its_seed():
    args = ["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
            "--batch", "1", "--prompt-len", "4", "--gen", "3"]
    a = tserve.serve(args + ["--seed", "1"])
    assert np.array_equal(a, tserve.serve(args + ["--seed", "1"]))


def test_cli_on_stacked_ranks_and_one_token(capsys):
    out = tserve.serve(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                        "cpu", "--batch", "4", "--prompt-len", "4", "--gen",
                        "1", "--data-mesh", "2", "--model-mesh", "4"])
    assert out.shape == (4, 1)
    assert "decode: 0 steps" in capsys.readouterr().out


@pytest.mark.parametrize("bad", [["--batch", "0"], ["--gen", "0"],
                                 ["--model-mesh", "0"]])
def test_cli_rejects_bad_sizes(bad):
    with pytest.raises(SystemExit):
        tserve.serve(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                      *bad])


def test_cli_refuses_encoder_only():
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.serve(["--arch", "hubert-xlarge", "--smoke", "--device",
                      "cpu"])


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve(["--arch", "llama3-8b", "--smoke"])
    with pytest.raises(RuntimeError):
        TModel(tconfigs.get_smoke("llama3_8b"))
