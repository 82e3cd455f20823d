"""The torch serving engine against the JAX one: greedy tokens (of a
dense, a MoE and a recurrent smoke model), the ``measure_throughput`` row
schema, sampling, and the device contract."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.inference.engine import ServingEngine as JaxServingEngine
from repro.inference.sampling import sample as jax_sample
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_smoke_config
from repro_torch.inference.engine import ServingEngine
from repro_torch.inference.sampling import sample
from repro_torch.models.transformer import Model
from repro_torch.weights import params_from_jax

ARCH = "llama3.1-8b"


def _engines(arch=ARCH):
    """Both engines on the fp32 smoke model with the same weights."""
    jcfg = jax_get_smoke_config(arch).scaled(compute_dtype=jnp.float32)
    tcfg = get_smoke_config(arch).scaled(compute_dtype=torch.float32)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.key(0))
    tmodel = Model(tcfg).load(
        params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return (JaxServingEngine(jmodel, params),
            ServingEngine(tmodel, device="cpu"))


def test_greedy_tokens_match_jax():
    jeng, teng = _engines()
    prompts = np.random.default_rng(0).integers(0, 256, (2, 8), dtype=np.int32)
    jres = jeng.generate(prompts, 8)
    tres = teng.generate(prompts, 8)
    assert tres.tokens.shape == (2, 8) and tres.tokens.dtype == np.int32
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    assert tres.prefill_s > 0 and tres.decode_s > 0 and tres.tokens_per_s > 0


def test_measure_throughput_rows_have_the_jax_schema():
    jeng, teng = _engines()
    jrows = jeng.measure_throughput(ii=6, oo=3, bb=2, reps=2)
    trows = teng.measure_throughput(ii=6, oo=3, bb=2, reps=2)
    assert len(trows) == len(jrows) == 2
    for jr, tr in zip(jrows, trows):
        assert list(tr) == list(jr)
        assert (tr["ii"], tr["oo"], tr["bb"]) == (6, 3, 2)
        assert all(isinstance(tr[k], float) and tr[k] > 0
                   for k in ("thpt", "prefill_s", "decode_s"))


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, device="cuda")


def test_sampling_matches_jax_greedy_and_masks_padding():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 1, 512)).astype(np.float32)
    logits[0, 0, 300] = 50.0            # in the vocab padding
    logits[1, 0, [7, 9]] = 20.0         # a tie: the first maximum wins
    got = sample(torch.from_numpy(logits), vocab_size=256)
    want = jax_sample(jnp.asarray(logits), jax.random.key(0), vocab_size=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1, 0] == 7

    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([sample(torch.from_numpy(logits), gen, temperature=1.0,
                              top_k=3, vocab_size=256) for _ in range(50)], 1)
    top3 = np.argsort(logits[:, 0, :256], axis=-1)[:, -3:]
    for row, allowed in zip(draws.numpy(), top3):
        assert set(row) <= set(allowed)
    with pytest.raises(ValueError, match="generator"):
        sample(torch.from_numpy(logits), temperature=1.0)


def test_cpu_engine_is_the_eager_loop():
    _, teng = _engines()
    prompts = np.random.default_rng(2).integers(0, 256, (2, 5), dtype=np.int32)
    teng.generate(prompts, 4)
    assert (teng.captures, teng.replays) == (0, 0)
    with pytest.raises(ValueError, match="cache slots"):
        teng.generate(prompts, 4, max_len=7)


def test_decode_graph_step_gives_the_eager_tokens(monkeypatch):
    """The graph's step, run eagerly on CPU tensors (no capture here):
    the greedy tokens that replays leave in ``history`` and ``tok`` are
    the eager loop's, with the cache filled in place by prefill."""
    from repro_torch.inference.engine import DecodeGraph
    _, teng = _engines()
    model = teng.model
    prompts = np.random.default_rng(3).integers(0, 256, (2, 6), dtype=np.int32)
    want = teng.generate(prompts, 5).tokens
    monkeypatch.setattr(DecodeGraph, "_capture", lambda self: None)
    graph = DecodeGraph(model, 2, 11)
    logits, _ = model.prefill(torch.from_numpy(prompts).long(),
                              cache=graph.cache)
    graph.start(sample(logits, vocab_size=model.cfg.vocab_size))
    with torch.inference_mode():
        for _ in range(4):
            graph.logits = graph._step()
    got = graph.history[:, 6:11].numpy()
    np.testing.assert_array_equal(got, want)
    assert int(graph.cache.pos_t) == 10
    assert torch.equal(graph.tok[:, 0], graph.history[:, 10])


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "xlstm-125m"])
def test_moe_and_recurrent_greedy_tokens_match_jax(arch, monkeypatch):
    """A MoE model (phi3.5-moe: top-2 of 4 experts, capacity 8 a decode
    step) and a recurrent one (xlstm: sLSTM and mLSTM states): the
    engine's greedy tokens are the JAX engine's, and the decode graph's
    step, run eagerly on CPU tensors, gives them again from a cache
    filled in place."""
    from repro_torch.inference.engine import DecodeGraph
    jeng, teng = _engines(arch)
    prompts = np.random.default_rng(4).integers(0, 256, (2, 8), dtype=np.int32)
    want = jeng.generate(prompts, 8).tokens
    np.testing.assert_array_equal(teng.generate(prompts, 8).tokens, want)
    model = teng.model
    monkeypatch.setattr(DecodeGraph, "_capture", lambda self: None)
    graph = DecodeGraph(model, 2, 15)
    logits, _ = model.prefill(torch.from_numpy(prompts).long(),
                              cache=graph.cache)
    graph.start(sample(logits, vocab_size=model.cfg.vocab_size))
    with torch.inference_mode():
        for _ in range(7):
            graph.logits = graph._step()
    np.testing.assert_array_equal(graph.history[:, 8:16].numpy(), want)


def _reference_greedy(jmodel, params, batch, oo):
    """The JAX model's greedy loop, ``prefill`` + ``decode_step``, fed by
    ``io.make_batch``: the oracle for the stub-frontend archs, which the
    reference engine (tokens only) cannot serve."""
    b, s = batch["tokens"].shape
    seq = s + (batch["patches"].shape[1] if "patches" in batch else 0)
    vocab = jmodel.cfg.vocab_size
    logits, cache = jax.jit(
        lambda p, x: jmodel.prefill(p, x, max_len=seq + oo))(params, batch)
    tok = jax_sample(logits, None, vocab_size=vocab)
    toks = [tok]
    step = jax.jit(jmodel.decode_step)
    for _ in range(oo - 1):
        logits, cache = step(params, cache, tok)
        tok = jax_sample(logits, None, vocab_size=vocab)
        toks.append(tok)
    return np.concatenate([np.asarray(t) for t in toks], axis=1)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
def test_stub_frontend_greedy_tokens_match_the_jax_model(arch, monkeypatch):
    """whisper (frames, cross attention) and internvl2 (patches before the
    prompt): the engine's greedy tokens through its ``inputs`` hook are
    the JAX model's greedy loop's on the same ``make_batch``, and the
    decode graph's step, run eagerly on CPU tensors, gives them again
    from a cache filled in place (cross K/V included); the greedy tokens
    sit after the patches in ``history``."""
    from repro.configs.shapes import ShapeSpec as JaxShapeSpec
    from repro.models import io as jio
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.inference.engine import DecodeGraph
    from repro_torch.models import io as tio
    jeng, teng = _engines(arch)
    model, ii, oo = teng.model, 8, 6
    seq = model.n_prefix + ii
    jb = jio.make_batch(jeng.model.cfg, JaxShapeSpec("p", seq, 2, "prefill"),
                        seed=5)
    want = _reference_greedy(jeng.model, jeng.params, jb, oo)
    arrays = tio.draw(model.cfg, ShapeSpec("p", seq, 2, "prefill"),
                      np.random.default_rng(5))
    prompts = arrays.pop("tokens")
    got = teng.generate(prompts, oo, inputs=arrays)
    np.testing.assert_array_equal(got.tokens, want)
    monkeypatch.setattr(DecodeGraph, "_capture", lambda self: None)
    graph = DecodeGraph(model, 2, seq + oo)
    extra = {k: torch.from_numpy(a) for k, a in arrays.items()}
    logits, _ = model.prefill(torch.from_numpy(prompts).long(),
                              cache=graph.cache, **extra)
    graph.start(sample(logits, vocab_size=model.cfg.vocab_size))
    with torch.inference_mode():
        for _ in range(oo - 1):
            graph.logits = graph._step()
    np.testing.assert_array_equal(graph.history[:, seq:seq + oo].numpy(),
                                  want)
    with pytest.raises(ValueError, match="cache slots"):
        teng.generate(prompts, oo, max_len=seq + oo - 2, inputs=arrays)


def test_measure_throughput_draws_the_stub_inputs_seeded(monkeypatch):
    """Each request's prompts and patches come from one seeded stream in
    ``io.draw``'s order; the rows keep the schema, ``ii`` the prompt's
    tokens without the patches."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models import io as tio
    _, teng = _engines("internvl2-1b")
    cfg = teng.model.cfg
    seen = []
    generate = teng.generate

    def spy(prompts, oo, max_len=None, inputs=None):
        seen.append((prompts, inputs))
        return generate(prompts, oo, max_len, inputs)
    monkeypatch.setattr(teng, "generate", spy)
    rows = teng.measure_throughput(ii=5, oo=3, bb=2, reps=2, seed=3)
    assert [(r["ii"], r["oo"], r["bb"]) for r in rows] == [(5, 3, 2)] * 2
    rng = np.random.default_rng(3)
    for prompts, inputs in seen:
        want = tio.draw(cfg, ShapeSpec("p", cfg.n_patches + 5, 2, "prefill"),
                        rng)
        np.testing.assert_array_equal(prompts, want["tokens"])
        assert list(inputs) == ["patches"]
        np.testing.assert_array_equal(inputs["patches"], want["patches"])
    assert len(seen) == 3
