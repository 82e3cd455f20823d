"""The port's ``Trainer`` against the reference's, and ports of the
reference's trainer tests (``tests/test_system.py``).

Both trainers start from the same parameters (the reference's
``Model.init``, converted by ``weights.params_from_jax``, fed to both by
``init_state``) and read the same pipeline; in fp32 every step's loss
agrees within 1e-4 relative over 12 AdamW steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.models.transformer import Model as JModel
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as jadamw_init
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import Trainer as JTrainer

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainConfig, Trainer
from repro_torch.weights import params_from_jax


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _trainer(cfg, shape, ckpt_dir, total, opt, ckpt_every=1000, device="cpu"):
    return Trainer(Model(cfg), shape, None,
                   TrainConfig(total_steps=total, ckpt_every=ckpt_every,
                               ckpt_dir=str(ckpt_dir), log_every=1000,
                               opt=opt), device=device)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b"])
def test_trainer_matches_reference_trainer_fp32(arch, tmp_path, monkeypatch):
    jcfg = jax_get_smoke_config(arch).scaled(compute_dtype=jnp.float32)
    tcfg = get_smoke_config(arch).scaled(compute_dtype=torch.float32)
    steps = 12
    jshape = JShapeSpec("t", seq_len=16, global_batch=2, kind="train")
    shape = ShapeSpec("t", seq_len=16, global_batch=2, kind="train")
    # numpy copies: the reference's jitted step donates its buffers
    params = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(7)))
    jt = JTrainer(JModel(jcfg), jshape, None,
                  JTrainConfig(total_steps=steps, ckpt_every=1000,
                               ckpt_dir=str(tmp_path / "j"), log_every=1000,
                               opt=JAdamWConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=steps)))
    def jax_state(seed=0):
        p = jax.tree.map(jnp.asarray, params)
        return p, jadamw_init(p)

    monkeypatch.setattr(jt, "init_state", jax_state)
    jparams, _ = jt.run()

    t = _trainer(tcfg, shape, tmp_path / "t", steps,
                 AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps))
    converted = params_from_jax(params, tcfg, "cpu")
    monkeypatch.setattr(t, "init_state",
                        lambda seed=0: (converted, adamw_init(converted)))
    tparams, opt = t.run()
    assert [h["step"] for h in t.history] == list(range(steps))
    jl = np.array([h["loss"] for h in jt.history])
    tl = np.array([h["loss"] for h in t.history])
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in t.history],
                               [h["grad_norm"] for h in jt.history],
                               rtol=1e-4)
    assert int(opt.step) == steps
    want = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_trainer_checkpoint_restart(tmp_path):
    """Fault-tolerance drill: train 6 steps, 'crash', resume from ckpt —
    final params must equal an uninterrupted 12-step run."""
    cfg = get_smoke_config("qwen3-0.6b")
    shape = ShapeSpec("t", seq_len=16, global_batch=2, kind="train")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)

    def make(dirname, total):
        return _trainer(cfg, shape, tmp_path / dirname, total, opt,
                        ckpt_every=6)

    # uninterrupted run
    p_full, _ = make("full", 12).run(seed=3)
    # interrupted run: 6 steps, then a fresh Trainer resumes to 12
    make("resume", 6).run(seed=3)
    t_b = make("resume", 12)
    p_res, _ = t_b.run(seed=3)
    assert [h["step"] for h in t_b.history] == list(range(6, 12))
    assert list(p_full) == list(p_res)
    for a, b in zip(p_full.values(), p_res.values()):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_trainer_loss_decreases(tmp_path):
    cfg = get_smoke_config("llama3.2-3b")
    shape = ShapeSpec("t", seq_len=32, global_batch=4, kind="train")
    t = _trainer(cfg, shape, tmp_path / "ck", 30,
                 AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=30))
    t.run(seed=0)
    first = np.mean([h["loss"] for h in t.history[:5]])
    last = np.mean([h["loss"] for h in t.history[-5:]])
    assert last < first - 0.1, (first, last)
    assert all(np.isfinite(h["grad_norm"]) and h["sec"] > 0
               for h in t.history)


def test_trainer_keeps_float32_parameters_and_casts_at_use(tmp_path):
    cfg = get_smoke_config("qwen3-0.6b")
    shape = ShapeSpec("t", seq_len=16, global_batch=2, kind="train")
    t = _trainer(cfg, shape, tmp_path, 1, AdamWConfig())
    params, opt = t.init_state(0)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.values())
    assert all(m.dtype == torch.float32 for m in opt.m.values())
    assert t.model.trainable and cfg.compute_dtype == torch.bfloat16
    seen = []
    t.run(on_step=lambda i, loss: seen.append((i, loss)))
    assert seen == [(0, t.history[0]["loss"])]
    assert (tmp_path / "step_00000001").is_dir()
    assert (tmp_path / "opt" / "step_00000001").is_dir()


def test_trainer_refuses_a_policy_and_wants_a_card_by_default(tmp_path):
    """A policy is taken since the policy path was ported (the name is
    the test's from before): the Trainer builds the reference's sharded
    step over a one-rank mesh, its parameter and ZeRO-1 placements from
    ``tree_shardings``.  Without ``device`` it wants a card."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_smoke_config("qwen3-0.6b")
    shape = ShapeSpec("t", seq_len=16, global_batch=2, kind="train")
    tc = TrainConfig(ckpt_dir=str(tmp_path))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        policy = ShardingPolicy(make_host_mesh(1))
        t = Trainer(Model(cfg), shape, policy, tc, device="cpu")
        assert t.policy is policy
        assert set(t._p_shard) == set(t._o_shard.m) == {
            k for k, _ in Model(cfg).init(
                torch.Generator().manual_seed(0)).named_parameters()}
        # ZeRO-1: each moment cut over data (every dim divides a 1-wide
        # axis), each parameter not
        assert all("data" in s.spec for s in t._o_shard.m.values())
        assert not any("data" in s.spec for s in t._p_shard.values())
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(Model(cfg), shape, None, tc)
    else:
        assert Trainer(Model(cfg), shape, None, tc).device.type == "cuda"
