"""Shared inputs of the train-loss tests: a smoke config in both
packages, the reference's parameters converted into a training model, a
seeded batch, and the reference's loss and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.transformer import Model as JModel

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import Model
from repro_torch.weights import params_from_jax

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 16   # S a multiple of Mamba's chunk (16)


def batch(cfg, seed=0):
    """tokens, labels (a few past the vocabulary, which the loss masks),
    and the frames or patches the config's frontend takes."""
    rng = np.random.default_rng(seed)
    text = S - (cfg.n_patches if cfg.frontend == "vision" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, text),
                                  dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, text),
                                  dtype=np.int32)}
    out["labels"][0, :3] = cfg.vocab_size + np.arange(3)
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def port_model(arch, remat=False, seed=0):
    """The port's fp32 training model of ``arch``'s smoke config, drawn
    from a seeded CPU generator, and its batch."""
    tcfg = get_smoke_config(arch).scaled(compute_dtype=torch.float32)
    model = Model(tcfg, remat=remat).init(
        torch.Generator().manual_seed(seed), train=True)
    return model, torch_batch(batch(tcfg, seed))


def pair(arch, dtype_name="float32", remat=False, seed=0):
    """(reference loss, reference grads as port-named tensors, the port's
    training model, its batch)."""
    jdt, tdt = DTYPES[dtype_name]
    jcfg = jax_get_smoke_config(arch).scaled(compute_dtype=jdt)
    tcfg = get_smoke_config(arch).scaled(compute_dtype=tdt)
    jmodel = JModel(jcfg)
    params = jmodel.init(jax.random.key(seed))
    b = batch(tcfg, seed)
    loss, grads = jax.jit(jax.value_and_grad(jmodel.train_loss))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    model = Model(tcfg, remat=remat).load(
        params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"),
        train=True)
    jgrads = params_from_jax(jax.tree.map(np.asarray, grads), tcfg, "cpu")
    return float(loss), jgrads, model, torch_batch(b)


def check(arch, remat=False):
    """The port's fp32 loss within 1e-5 relative of the reference's, each
    gradient within 1e-4 of its max-abs; returns the port's gradients."""
    jloss, jgrads, model, tb = pair(arch, remat=remat)
    loss = model.train_loss(tb)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    grads = dict((n, p.grad) for n, p in model.named_parameters())
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        want = jgrads[name].numpy()
        assert g is not None, name
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-12), (name, err)
    return grads
