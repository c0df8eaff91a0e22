"""The port's `Trainer` and data pipeline (`repro_torch.train.trainer`,
`repro_torch.data.tokens`) on the CPU: the mirror of `tests/test_trainer.py`
(loss goes down, an injected fault restores, a straggler is flagged,
compression converges, the data are deterministic, prefetch), the
`SyntheticTokens` batches against JAX's, and checkpoints across packages:
each package's `Trainer` resumes the other's, and the first steps after
the resume match an uninterrupted run of the other package within 1e-5,
with the manifest keys of the reference."""

import json
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.configs import ARCHS as JAX_ARCHS
from repro.data.tokens import DataConfig as JDataConfig
from repro.data.tokens import SyntheticTokens as JSyntheticTokens
from repro.models.config import reduced as jreduced
from repro.models.model_zoo import get_model as jget_model
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import pytree
from repro_torch.configs import get_arch
from repro_torch.data.tokens import DataConfig, PrefetchLoader, SyntheticTokens, stub_inputs
from repro_torch.models.config import reduced
from repro_torch.models.model_zoo import get_model
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import StragglerWatchdog, Trainer, TrainerConfig

from _torch_parity import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab=256, n_heads=4, n_kv_heads=2,
            head_dim=16)


def _tiny_model():
    return get_model(reduced(get_arch("qwen2.5-3b"), **TINY))


def _data(cfg, batch=4, seq=32):
    return DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)


def _trainer(tmp_path, steps, every=1000, compress=False, hook=None, lr=1e-3, warmup=5,
             batch=4, seq=32, **tkw):
    model = _tiny_model()
    return Trainer(model, opt.OptimizerConfig(lr=lr, warmup_steps=warmup, total_steps=steps),
                   TrainerConfig(total_steps=steps, checkpoint_every=every,
                                 checkpoint_dir=str(tmp_path), compress_grads=compress, **tkw),
                   _data(model.cfg, batch, seq), step_hook=hook, device="cpu")


def _first_last(hist):
    return (np.mean([h["loss"] for h in hist[:5]]), np.mean([h["loss"] for h in hist[-5:]]))


def test_loss_decreases(tmp_path):
    first, last = _first_last(_trainer(tmp_path, 60).run(resume=False)["history"])
    assert last < first - 0.2, (first, last)


def test_fault_injection_restores_and_finishes(tmp_path):
    boom = {"armed": True}

    def hook(step):
        if step == 25 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    out = _trainer(tmp_path, 40, every=10, hook=hook, warmup=100).run(resume=False)
    assert out["restarts"] == 1
    assert out["final_step"] == 40
    # the failure hit before step 25 ran; the restore was from the step-20
    # checkpoint, so 20-24 ran twice, 19 once, 25 once (hook disarmed)
    steps = [h["step"] for h in out["history"]]
    assert steps.count(24) == 2 and steps.count(19) == 1 and steps.count(25) == 1
    # the replayed steps start from the restored state: the same losses
    by_step = {}
    for h in out["history"]:
        by_step.setdefault(h["step"], []).append(h["loss"])
    for s in range(20, 25):
        np.testing.assert_allclose(by_step[s][0], by_step[s][1], rtol=1e-6)


def test_too_many_failures_raise(tmp_path):
    def hook(step):
        if step == 3:
            raise RuntimeError("injected node failure")

    tr = _trainer(tmp_path, 6, every=2, hook=hook, max_restarts=2)
    with pytest.raises(RuntimeError, match="injected"):
        tr.run(resume=False)
    assert tr.restarts == 3


def test_straggler_watchdog(tmp_path):
    def hook(step):
        if step == 15:
            time.sleep(1.0)  # injected slow step

    out = _trainer(tmp_path, 20, hook=hook, batch=2, seq=16,
                   straggler_factor=3.0).run(resume=False)
    assert 15 in out["stragglers"]


def test_watchdog_warmup_and_ema():
    w = StragglerWatchdog(factor=3.0, alpha=0.5)
    assert not w.observe(0, 10.0) and not w.observe(1, 1.0)   # warmup seeds the EMA
    assert w.ema == 1.0
    assert w.observe(2, 3.5) and w.flagged == [2] and w.ema == 1.0
    assert not w.observe(3, 2.0) and w.ema == 1.5


def test_grad_compression_converges(tmp_path):
    out = _trainer(tmp_path, 60, compress=True).run(resume=False)
    first, last = _first_last(out["history"])
    assert last < first - 0.15, (first, last)
    assert out["state"]["err"] is not None


def test_data_determinism():
    cfg = DataConfig(vocab=1000, seq_len=64, global_batch=4, seed=3)
    b1 = SyntheticTokens(cfg).batch(17)
    b2 = SyntheticTokens(cfg).batch(17)
    assert b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"], b2["tokens"])


def test_prefetch_matches_direct():
    cfg = DataConfig(vocab=500, seq_len=32, global_batch=2, seed=1)
    src = SyntheticTokens(cfg)
    loader = PrefetchLoader(src, start_step=5)
    try:
        for expect in range(5, 9):
            step, batch = next(loader)
            assert step == expect
            assert torch.equal(batch["tokens"], src.batch(step)["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


@pytest.mark.parametrize("seed,step,vocab,seq,batch", [
    (0, 0, 256, 32, 4), (0, 17, 1000, 64, 4), (3, 5, 151936, 40, 2), (9, 123, 50, 8, 3)])
def test_synthetic_tokens_equal_jax(seed, step, vocab, seq, batch):
    """Exactly the reference's batches, tokens only; `stub_inputs` draws a
    stub frontend's inputs apart, float32 and the same for each (seed, step)."""
    cfg = DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    jb = JSyntheticTokens(JDataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                                      seed=seed)).batch(step)
    ours = SyntheticTokens(cfg).batch(step)
    assert set(ours) == {"tokens", "targets"}
    for k in ("tokens", "targets"):
        assert ours[k].dtype == torch.int32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(jb[k]))
    stubs = stub_inputs(cfg, step, {"frames": (seq // 4, 1280)})
    assert tuple(stubs["frames"].shape) == (batch, seq // 4, 1280)
    assert stubs["frames"].dtype == torch.float32
    again = stub_inputs(cfg, step, {"frames": (seq // 4, 1280)})
    assert torch.equal(stubs["frames"], again["frames"])


# -- checkpoints across packages ----------------------------------------------------

RESUME_AT, MORE = 4, 3


def _jax_trainer(tmp_path, steps, compress=False, every=1000):
    cfg = jreduced(JAX_ARCHS["qwen2.5-3b"], **TINY)
    model = jget_model(cfg)
    return JTrainer(model, jopt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                    JTrainerConfig(total_steps=steps, checkpoint_every=every,
                                   checkpoint_dir=str(tmp_path), compress_grads=compress),
                    JDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0))


def _port_trainer(tmp_path, steps, compress=False, every=1000):
    model = _tiny_model()
    return Trainer(model, opt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                   TrainerConfig(total_steps=steps, checkpoint_every=every,
                                 checkpoint_dir=str(tmp_path), compress_grads=compress),
                   _data(model.cfg), device="cpu")


def _uninterrupted(make, directory):
    """An uninterrupted run of RESUME_AT + MORE steps that checkpoints at
    RESUME_AT on the way: (its directory, its losses)."""
    hist = make(directory, RESUME_AT + MORE, every=RESUME_AT).run(resume=False)["history"]
    return directory, [h["loss"] for h in hist]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _uninterrupted(_jax_trainer, tmp_path_factory.mktemp("jax_run"))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return _uninterrupted(_port_trainer, tmp_path_factory.mktemp("port_run"))


def _step_dir(directory, step):
    return os.path.join(directory, f"step_{step:08d}")


def _manifest(directory, step):
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)


def _resume_copy(run_dir, tmp_path):
    """A directory holding only the run's checkpoint at RESUME_AT."""
    d = tmp_path / "ckpt"
    shutil.copytree(_step_dir(run_dir, RESUME_AT), _step_dir(d, RESUME_AT))
    return d


def test_port_resumes_a_jax_checkpoint(tmp_path, jax_run):
    """JAX's Trainer checkpoints at step RESUME_AT; the port's resumes it and
    runs MORE steps, whose losses match JAX's uninterrupted run."""
    jax_dir, jax_losses = jax_run
    out = _port_trainer(_resume_copy(jax_dir, tmp_path), RESUME_AT + MORE).run(resume=True)
    assert out["final_step"] == RESUME_AT + MORE
    np.testing.assert_allclose([h["loss"] for h in out["history"]], jax_losses[RESUME_AT:],
                               rtol=1e-5)


def test_jax_resumes_a_port_checkpoint(tmp_path, jax_run, port_run):
    """The port's Trainer checkpoints at step RESUME_AT, with JAX's manifest
    keys and types; JAX's resumes it, and its MORE steps match the port's
    uninterrupted run."""
    (jax_dir, _), (port_dir, port_losses) = jax_run, port_run
    ours, theirs = _manifest(port_dir, RESUME_AT), _manifest(jax_dir, RESUME_AT)
    assert [e["key"] for e in ours["leaves"]] == [e["key"] for e in theirs["leaves"]]
    assert [(e["shape"], e["dtype"]) for e in ours["leaves"]] == \
        [(e["shape"], e["dtype"]) for e in theirs["leaves"]]
    assert ours["extras"] == theirs["extras"] == {"step": RESUME_AT, "data_seed": 0}
    jout = _jax_trainer(_resume_copy(port_dir, tmp_path), RESUME_AT + MORE).run(resume=True)
    assert jout["final_step"] == RESUME_AT + MORE
    np.testing.assert_allclose([h["loss"] for h in jout["history"]], port_losses[RESUME_AT:],
                               rtol=1e-5)


def test_checkpoint_keys_with_compression_equal_jax(tmp_path):
    """With compression the tree gains `err`: the port's checkpoint keys
    (flatten order) and shapes equal what JAX's Trainer writes."""
    jt = _jax_trainer(tmp_path / "j", 1, compress=True)
    js = jt.init_state()
    jtree = {"params": js["params"], "opt": js["opt"], "err": js["err"]}
    jitems, _ = jmanager._flatten_with_paths(jtree)
    pt = _port_trainer(tmp_path / "p", 1, compress=True)
    items = pytree.flatten_with_paths(pt.checkpoint_tree(pt.init_state()))
    assert [k for k, _ in items] == [k for k, _ in jitems]
    assert [tuple(v.shape) for _, v in items] == [tuple(np.shape(v)) for _, v in jitems]
    assert any(k.startswith("err/") for k, _ in items)
    assert ("opt/.step", ()) in [(k, tuple(v.shape)) for k, v in items]
    jax.block_until_ready(js["params"])
